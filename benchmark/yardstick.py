"""The fused choice kernel's least time on an H100, frozen.

The work one ``fused_choice`` call needs (bytes moved and fp32
instructions) and the least time an H100 could take for it, as the
program stated them when this benchmark was defined. Kept here so that
the kernel's roofline share counts the same work whatever implements the
kernel later.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: H100 SXM data sheet: HBM3 bandwidth
H100_BYTES_PER_S = 3.35e12
#: the data sheet's 67 TFLOP/s fp32 (outside the tensor cores) counts a
#: fused multiply-add as two operations: one fp32 instruction per lane per
#: clock. The kernel keeps every add and multiply apart (``--fmad=false``),
#: so each add, multiply, compare, min/max and select is an instruction of
#: its own, at half that rate.
H100_FP32_INSTR_PER_S = 67e12 / 2


def fused_choice_cost(T: int, N: int, R: int, families,
                      eligible_rows: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, fp32 instructions) one call needs: each input read once,
    each output written once, pair work over the eligible rows only (all T
    when None):
    - per node: the fit threshold (abs, mul, 2 adds per dim); binpack's
      w*inv and sum of (used*w)*inv (4 per dim);
    - per task: the scalar-dim request <= 10 test (1 per dim past the 2nd);
    - per (eligible task, node) pair: one compare per dim, the node_static
      add (none with no score family), the mask select, row and column
      max; binpack 2R + 2; kube 29, 30 where binpack also scores.
    Boolean and int8 mask logic is not fp32 work."""
    E = T if eligible_rows is None else eligible_rows
    nbytes = (E * N                      # int8 signature mask, eligible rows
              + 4 * (T * R + T)          # init_req, eligible
              + 4 * (3 * N * R + 2 * N)  # avail, used, inv_alloc; static, pods_ok
              + 4 * (5 + R)              # pars
              + 4 * (2 * T + N))         # best_s, best_i, node_max
    binpack, kube = "binpack" in families, "kube" in families
    per_pair = R + 3 + (binpack or kube)
    per_node = 4 * R
    per_task = max(R - 2, 0)
    if binpack:
        per_pair += 2 * R + 2
        per_node += 4 * R
    if kube:
        per_pair += 30 if binpack else 29
    return nbytes, E * N * per_pair + N * per_node + T * per_task


def bound_ms(nbytes: int, ops: int) -> Tuple[float, str]:
    """The least time an H100 could take for (bytes, fp32 instructions),
    and which of the two sets it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_INSTR_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
