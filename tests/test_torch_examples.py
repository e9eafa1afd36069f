"""The JAX package's LM examples in their port form, on the CPU.

``examples/train_lm.py`` is ``launch.train --workload lm --arch
mamba2-780m --reduced --steps 60 --ckpt-dir …`` and
``examples/serve_lm.py`` is ``launch.serve --workload lm --arch gemma2-2b
--reduced --batch 4 --prompt-len 48 --gen 24`` (README, "PyTorch/CUDA
port"). Each argv list runs here as the README gives it, with
``--device cpu``; the training run's step count is cut from 60 to 2 to
keep the test short, and a rerun with one more step resumes from the
checkpoint the first left.
"""

import pytest
import torch

from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train

torch.set_num_threads(1)

EXAMPLES = {
    "train_lm": (launch_train, ["--workload", "lm", "--arch", "mamba2-780m",
                                "--reduced", "--steps", "60"]),
    "serve_lm": (launch_serve, ["--workload", "lm", "--arch", "gemma2-2b",
                                "--reduced", "--batch", "4", "--prompt-len",
                                "48", "--gen", "24"]),
}


def _with_steps(argv, steps):
    i = argv.index("--steps")
    return argv[:i + 1] + [str(steps)] + argv[i + 2:]


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_lm_example_runs_on_the_cpu(example, tmp_path, capsys):
    launcher, argv = EXAMPLES[example]
    argv = argv + ["--device", "cpu"]
    if launcher is launch_serve:
        assert launcher.main(argv) == 0
        out = capsys.readouterr().out
        assert "gemma2-2b on cpu" in out and "prefill 4x48 tokens" in out
        assert "decode: 92 tokens" in out   # 4 rows × 23 decode steps
        return
    argv += ["--ckpt-dir", str(tmp_path)]
    assert launcher.main(_with_steps(argv, 2)) == 0
    out = capsys.readouterr().out
    assert "mamba2-780m:" in out and "finished at step 2" in out
    assert launcher.main(_with_steps(argv, 3)) == 0
    out = capsys.readouterr().out
    assert "[resume] restored checkpoint at step 2" in out
    assert "finished at step 3" in out
