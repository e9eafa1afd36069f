"""The port's source lint (``repro_torch.analysis.source_lint``) tested
against itself: the port's tree lints clean; each of its six rules
catches a violation planted in a throwaway tree under ``tmp_path``; a
justified allow suppresses and a bare one does not."""

import shutil
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import source_lint as L

REPO = Path(__file__).resolve().parent.parent


def test_port_tree_lints_clean():
    vs = L.lint_repo(REPO)
    assert vs == [], "\n".join(str(v) for v in vs)


def test_lint_covers_the_port_the_smoke_and_the_port_tests():
    rel = {p.relative_to(REPO).as_posix() for p in L.repo_files(REPO)}
    assert "chip_smoke.py" in rel
    assert "src/repro_torch/analysis/source_lint.py" in rel
    assert "tests/test_torch_lint.py" in rel
    assert not any(r.startswith(("src/repro/", "tests/test_analysis"))
                   for r in rel)


def test_rules_are_the_reference_rules_renamed():
    from repro.analysis.source_lint import RULES
    renamed = {"compat-door": "foreign-import",
               "pallas-call-site": "kernel-entry-site"}
    assert L.RULES == tuple(renamed.get(r, r) for r in RULES)


@pytest.fixture()
def tree(tmp_path):
    shutil.copy(REPO / "pyproject.toml", tmp_path / "pyproject.toml")

    def plant(rel, source):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
        return L.lint_file(path, tmp_path)
    return plant


def _rules(vs):
    return sorted(v.rule for v in vs)


# each rule's planted violation: (path in the tree, source, rules caught)
PLANTED = {
    "foreign-import": ("src/repro_torch/bad_import.py", """\
        import jax
        from repro.core import cgtrans
        import ml_dtypes
        from jaxlib import xla_client
        """, ["foreign-import"] * 4),
    "kernel-entry-site": ("src/repro_torch/core/bad_entry.py", """\
        import ctypes
        from repro_torch.kernels.gas_scatter import kernel as K
        from repro_torch.kernels.flash_attention.kernel import _load

        def call():
            lib = ctypes.CDLL("libgas_scatter.so")
            return K._load(), K._lib, lib
        """, ["kernel-entry-site"] * 4),
    "collective-site": ("src/repro_torch/core/bad_collective.py", """\
        import torch.distributed as td
        from torch.distributed import all_reduce

        def leak(x, scatter):
            td.all_to_all_single(x, x)
            all_reduce(x)
            scatter(x)           # a local name, not the collective
        """, ["collective-site"] * 2),
    "unticked-dispatch": ("src/repro_torch/core/bad_dispatch.py", """\
        from repro_torch.kernels.gas_scatter import kernel as K
        RAW = K.gas_scatter_dense

        def scatter_rows(work, dst, vals, n):
            return K.gas_scatter_banded(work, dst, vals, n)

        def _private(work, dst, vals, n):
            return K.gas_scatter_banded(work, dst, vals, n)

        def ticked(work, dst, vals, n):
            _tick("kernel_scatter")
            return K.gas_scatter_banded(work, dst, vals, n)
        """, ["unticked-dispatch"] * 2),
    "unknown-marker": ("tests/test_torch_bad_marker.py", """\
        import pytest

        @pytest.mark.bogus_tier
        def test_x():
            pass

        @pytest.mark.lint
        def test_y():
            pass
        """, ["unknown-marker"]),
    "f64-literal": ("src/repro_torch/bad_f64.py", """\
        import numpy as np
        import torch
        a = np.zeros(3, np.float64)
        b = torch.zeros(3, dtype="float64")
        """, ["f64-literal"] * 2),
}


@pytest.mark.parametrize("rule", L.RULES)
def test_planted_violation_is_caught(tree, rule):
    rel, source, want = PLANTED[rule]
    assert _rules(tree(rel, source)) == want


def test_scoped_rules_leave_the_tests_alone(tree):
    """Tests import both packages, build float64 oracles and may spawn
    collectives of their own: those rules cover the program only."""
    vs = tree("tests/test_torch_oracle.py", """\
        import jax
        import numpy as np
        import torch.distributed as dist

        def test_x():
            dist.barrier()
            return np.float64(1.0)
        """)
    assert vs == []


def test_allowlisted_sites_lint_clean(tree):
    assert tree("src/repro_torch/core/collectives.py", """\
        import torch.distributed as dist

        def gather(o, i):
            dist.all_gather_into_tensor(o, i)
        """) == []
    assert tree("src/repro_torch/kernels/gas_scatter/kernel.py", """\
        import ctypes
        _lib = None

        def _load():
            return ctypes.CDLL("x.so")
        """) == []


def test_justified_allow_suppresses(tree):
    assert tree("src/repro_torch/allowed.py", """\
        import numpy as np
        x = np.float64(1.0)  # lint: allow(f64-literal): a host-side bound
        """) == []


def test_bare_allow_does_not_suppress(tree):
    vs = tree("src/repro_torch/bare_allow.py", """\
        import numpy as np
        x = np.float64(1.0)  # lint: allow(f64-literal)
        """)
    assert _rules(vs) == ["f64-literal"]


def test_allow_names_its_rule(tree):
    vs = tree("src/repro_torch/wrong_allow.py", """\
        import numpy as np
        x = np.float64(1.0)  # lint: allow(foreign-import): wrong rule
        """)
    assert _rules(vs) == ["f64-literal"]


def test_main_exits_1_on_a_violation(tree, tmp_path, capsys):
    tree("src/repro_torch/bad_f64.py", PLANTED["f64-literal"][1])
    assert L.main([str(tmp_path)]) == 1
    assert "[f64-literal]" in capsys.readouterr().err
    assert L.main([str(REPO)]) == 0
