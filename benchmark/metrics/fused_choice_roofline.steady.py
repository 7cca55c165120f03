"""The fused choice kernel's share of its roofline in the traced cycles:
the sum of each call's least time on an H100 (``benchmark.yardstick``, at
the call's T, N, R, families and eligible rows) over the sum of the
``fused_choice`` kernels' device time. Against the published peaks; the
card's power limit is in PERF.md beside each reading."""

from benchmark.readers import trace_value


def read(run):
    spent = trace_value(run, "fused_choice_s")
    bound = trace_value(run, "fused_choice_bound_s")
    if not spent or not bound:
        return None
    return 100.0 * bound / spent
