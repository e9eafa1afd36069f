"""Static budgets of the sharded dataflows (``budgets``)."""
