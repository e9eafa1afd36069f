"""The port's accounting: the sharded dataflows' static budgets
(``budgets``), the contract registry checked by counting real runs
(``contracts``), the dtype rules over those runs (``dtype_flow``), the
counted rows of ``BENCH_collective_bytes.json`` (``counted_rows``) and the
AST lint of the port (``source_lint``)."""
