"""slamrs_tpu_torch: the simulator and its SLAM filters in PyTorch, on one
NVIDIA H100.

A port of :mod:`slamrs_tpu` (JAX on a TPU), which stays the reference:
the RBPF grid-SLAM rollout, ICP scan-to-map odometry and EKF landmark
SLAM.  The layout mirrors it so each module has an obvious counterpart:

* ``core/``    pose/scan tuples, angle math, the odometry motion model;
* ``ops/``     raycast, grid geometry, resampling, the fused update, the
  copy-on-write and tile-pool resamples, ICP;
* ``models/``  the simulator, the particle-filter SLAM update, the ICP
  point mapper and the EKF;
* ``graph/``   the YAML loader, the fused world (rollouts) and the host
  node graph (pub/sub, the nodes, ``App``);
* ``parallel/`` fleets sharded over a ``(world, particle)`` device mesh;
* ``utils/``, ``viz/``, ``io/``  timing and spans, checkpoints, the shape
  renderer and framebuffer, keyboard teleop;
* ``kernels/`` build and load of the hand-written CUDA kernels in ``csrc/``.

Every entry point takes an explicit ``device``; nothing falls back from
CUDA to the CPU.  On a CPU tensor a kernel wrapper runs its plain PyTorch
version (the tests use that path); on a CUDA tensor it launches the
kernel or raises.  Importing the package never builds a kernel.
"""
