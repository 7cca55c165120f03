"""PyTorch/CUDA port of the allocate solve.

Counterpart of the JAX package ``volcano_tpu`` for the session hot path:
snapshot flatten (``ops.arrays``) -> round solve (``ops.solver``) -> compact
decode, with the per-round task x node choice as a hand-written CUDA kernel
for Hopper (``csrc/fused_choice.cu``, wrapped by ``ops.fused_choice``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
