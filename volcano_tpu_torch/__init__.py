"""PyTorch/CUDA port of the scheduling cycle.

Counterpart of the JAX package ``volcano_tpu``: ``scheduler.Scheduler``
runs the default conf's cycle (enqueue, allocate, backfill) over the
control plane's own copies (``framework``, ``plugins``, ``actions``,
``cache``), and allocate takes the device path: event-sourced ordering
(``ops.ordering``) and flatten (``ops.arrays``) -> the device-resident
arena (``ops.device_cache``) -> round solve (``ops.solver``) with the
per-round task x node choice as a hand-written CUDA kernel for Hopper
(``csrc/fused_choice.cu``, wrapped by ``ops.fused_choice``) -> async
result readback (``ops.pipeline``) -> Statement replay. In the sharded
mode the solve splits the node axis over a device mesh (``parallel``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
