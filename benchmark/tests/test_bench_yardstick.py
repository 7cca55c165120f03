"""The benchmark's frozen yardstick counts what the port's does today:
fused_choice_cost, bound_ms and the two H100 peaks at the headline shape
(T=10240, N=2048, R=2), the shard shape (N=512) and the steady bucket
of default-2k.steady (T=112, N=2048), and at hdrf's (T=2048, N=1024,
R=3)."""

import sys

import pytest

from tiny import REPO

sys.path.insert(0, REPO)

from benchmark import yardstick  # noqa: E402


@pytest.mark.parametrize("T,N,R", [(10240, 2048, 2), (10240, 512, 2),
                                   (112, 2048, 2), (2048, 1024, 3)])
@pytest.mark.parametrize("families", [("binpack",), ("kube",),
                                      ("binpack", "kube")])
@pytest.mark.parametrize("eligible", [None, 1, 97])
def test_frozen_yardstick_equals_the_ports(T, N, R, families, eligible):
    from volcano_tpu_torch.ops import fused_choice as fc
    assert yardstick.H100_BYTES_PER_S == fc.H100_BYTES_PER_S
    assert yardstick.H100_FP32_INSTR_PER_S == fc.H100_FP32_INSTR_PER_S
    got = yardstick.fused_choice_cost(T, N, R, families, eligible)
    assert got == fc.fused_choice_cost(T, N, R, families, eligible)
    assert yardstick.bound_ms(*got) == fc.bound_ms(*got)
