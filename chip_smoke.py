#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``slamrs_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one line, any failure raising (exit code != 0):

1. device: requires CUDA (no CPU path) and prints the card's name and
   power limit from nvidia-smi;
2. build: compiles the CUDA kernels from ``slamrs_tpu_torch/csrc``, then
   counts the CUDA launches of one K4 call at bench.py's ICP batch and at
   the ICP mapper's shape under ``torch.profiler`` (gate: one kernel, no
   memset);
2b. ``kernel_vs_plain_sim_frame``: the simulator kernel
   (``csrc/sim_frame.cu``) against its plain version on the card, every
   output bitwise (pose, accumulators, distances, strengths, valid,
   present, the beam table) on the scenes of ``grid_slam_fused.yaml``,
   ``grid_slam.yaml`` and ``icp_test.yaml``, one world at each of twelve
   edge poses (a beam along a wall, beams through segment ends, hits past
   the range, poses outside the room) and 256 worlds, 0, 1 or 5 idle
   ticks before the last, the scan on and off; the roundings it repeats
   bitwise against ATen (cos and sin over 2**20 angles, ``deg2rad`` over
   100,000 beams, the division by the wheel base); then its device time
   beside the plain chain's at one world and at 256, for a 5 Hz frame
   and a one-tick frame (``kernel_time_sim_frame``);
3. kernel vs plain version at ``[1024, 80, 128]`` bf16 (0.05 m) and
4. at ``[1024, 200, 256]`` bf16 (0.02 m): static and traced beam
   spacing, the 360-beam scan, a 90-beam partial sector with mixed flags,
   and a 360-beam scan with a third of its beams out to 5 m (past the
   1 m range and the quantizer's cap) and six poses on the grid's column
   and row edges; non-identity ancestors, maps holding log-odds with
   ~30 % exact zeros.  Gates: maps equal by value (max |diff| 0), the
   likelihood within rtol 1e-5 / atol 1e-4, one launch counted per call;
5. the main path: ``make_fused`` with the ``configs/grid_slam_fused.yaml``
   values (1,024 particles, 4 x 4 m at 0.05 m, bf16) runs
   ``rollout_cadence`` for 300 ticks at seed 0; the kernel must launch
   once per scan frame, outputs must be finite, the weights sum to 1, and
   the best-particle pose RMSE against ground truth must be <= 0.08 m
   (the JAX package gives 0.028 m over these ticks on the CPU with 64 or
   256 particles; the draws differ here and drift is chaotic across
   seeds).  Then 150 ticks at 0.02 m cells under the same checks except
   the RMSE bound;
6. times on the card: kernel and plain version (device time from CUDA
   events, median of 20 after 3 warm-ups) at both shapes, the wrapper
   with its host-side preparation, rollout ticks/s of a warm 900-tick
   headline run, the peak device memory, and a profiled 300-tick run's
   device busy time, idle share and kernel launches;

then BASELINE config 3 (1,024 particles x 50 x 50 m maps at 0.05 m, bf16:
a 2.1 GB dense map set, or a 2.35 GB tile pool):

7. K2 (copy on write) against its plain version on ``[1024, 1000, 1024]``
   bf16 maps under bench.py's 50 %-duplicate plan, a systematic resample
   of peaked weights, and the identity plan; gate: bitwise;
8. K3 (tiled update) against its plain version on the config-3 pool
   ``[20480, 56, 1024]``, 3 updates with lineage relabels, static and
   traced spacing, 360 beams, a 90-beam sector, and the over-range scan
   with poses on the column and row edges; two poses pinned to the
   y-edges throughout; then the same at 4 x 4 m, 0.02 m (a 3-band span).
   Gates: materialized maps equal by value, likelihood rtol 1e-5 /
   atol 1e-4, tables equal, padded column tail exactly 0;
9. on config-3 inputs within the range and over it (edge poses), K1 in
   lineage mode and in place against its plain version (maps equal by
   value, likelihood gate), then K3 against both K1 modes: maps and
   likelihood bitwise, over the range for every particle whose dense
   and tiled windows start on the same row (at the top edge the tiled
   origin clips into the band padding, so over-range beams mark other
   rows there, in both packages);
10. config-3 rollouts of 300 ticks through ``make_fused``: auto (tiled,
    K3 once per frame, K1 never), pinned deferred (``resample_cow=
    "staged", fused_resident=True``: K1 lineage; best pose within 1e-5 m
    of the tiled run) and copy on write (``resample_cow=True``: K1 in
    place and K2 once per frame); finite outputs, weights summing to 1,
    RMSE <= 0.08 m;
11. the copy-on-write and tiled plans and one tiled config-3 update
    under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
12. times: K2, its plain version and ``index_copy_`` on bench.py's plan;
    K3 and its plain version after one resample; K1 in place; warm
    900-tick tiled and copy-on-write rollouts with their peak memory; a
    profiled 300-tick tiled run;

then ICP odometry (BASELINE config 1) and EKF landmark SLAM:

13. K4 (nearest neighbours) against its plain version, indices bitwise,
    on bench.py's ICP batch (2,048 problems of 360 x 360), at the ICP
    mapper's shape ``[1, 360] x [1, 16384]`` with ``q_count`` in {0, 1,
    43, 44, 45, 360, 372, 373, 374, 10000, 16384} (both edges of its
    44-chunk q split), on clouds of duplicated points within a chunk and
    across chunks (ties go to the first index), far from the origin
    (many exact ties), with negative distances, at coordinates near
    1e-20 m (subnormal products), with +-0 coordinates (ties at d2 = 0),
    and with 1, 33 and 361 source points;
14. the ICP world: ``compile_world(configs/icp_test.yaml)`` for 900 ticks;
    K4 launches 10 times per frame, the map fills its 16,384 points,
    outputs are finite and the ICP pose RMSE is <= 0.04 m (the JAX package
    gives 0.0205 m on the CPU); the first 300 ticks run again on the CPU
    (plain versions) and must agree frame by frame within 2e-3 m;
15. the EKF world: ``compile_world(configs/landmarks.yaml)`` for 300
    ticks; finite outputs and EKF pose RMSE <= 0.03 m (the JAX package
    gives 0.0091 m on the CPU with its own draws);
16. one ICP mapper update at the full map and one EKF update under
    ``torch.cuda.set_sync_debug_mode("error")``;
17. times: K4, its plain version and the XLA form in torch (``baddbmm``,
    mask, ``argmin``) at bench.py's batch and the mapper's shape, with
    the CUDA launches of one K4 call (from phase 2) and K4's bound over
    the q lanes below
    ``q_count`` (the figure over all lanes beside it); batched ICP
    iterations per second at bench.py's batch; warm 900-tick ICP and
    300-tick EKF rollouts with their peak memory; a profiled 300-tick ICP
    run with K4's own device time and launches;

then grid SLAM's dda (the default ``integrate``, the fidelity path) and
dense integrators, plain PyTorch with no kernel of their own:

18. the grid functions on the card against the same on the CPU, on
    random 1,024-particle inputs at 0.05 m (edge poses, beams past the
    range): ``traverse_ray`` on identical grid coordinates bitwise;
    ``grid_integrate`` and ``grid_integrate_dense`` on >= 99.9 % of cells
    within 5e-3 (``tests/test_parity.py``'s map gate: the card's cos, sin
    and atan2 are a few ulps from the CPU's); ``grid_log_likelihood``
    within rtol 1e-5 / atol 1e-4 on >= 99.9 % of the particles;
    ``grid_integrate`` twice on the card bitwise equal (the sort-based
    ``index_put_`` accumulate); the device time of each;
19. ``compile_world(configs/grid_slam.yaml)`` (dda, 10 particles at
    0.02 m) for 300 ticks with numpy draws injected: no kernel launched,
    finite outputs, weights summing to 1, best-pose RMSE <= 0.15 m (the
    JAX package gives 0.012-0.052 m on the CPU over seeds 0-2); the same
    ticks and draws on the CPU: best poses within 0.04 m (2 cells) RMSE,
    and the frames whose ancestors differ are printed;
20. ``make_fused`` with the headline's scene and cadence at
    ``integrate="dda"`` and ``"dense"`` (1,024 particles, 0.05 m, maps
    ``f32[1024, 80, 80]``: bench.py's ``dda_parity_path`` shape) for 300
    ticks: no kernel launched, finite outputs, RMSE <= 0.08 m (the JAX
    package gives 0.018 and 0.027 m on the CPU);
21. ``tests/test_path_deviation.py`` on the card (its scene, odometry and
    draws, carried here as numbers): fused (K1 once per update), dense and
    dda; best-pose RMSE against dda <= 2 cells and occupancy agreement
    >= 90 % of the touched cells;
22. one dda and one dense update at the headline shape under
    ``torch.cuda.set_sync_debug_mode("error")``;
23. times: warm 300-tick dda, dense and ``grid_slam.yaml`` runs (ticks/s,
    peak memory) and a profiled 300-tick dda run (device busy time, idle
    share, launches per tick);

then fleets, batched worlds on one card (BASELINE config 5, bench.py's
``fleet`` cell: 256 worlds x 10 particles on 4 x 4 m maps at 0.02 m,
f32 ``[256, 10, 200, 256]``, ``integrate="fused"``):

24. K1 with the world axis against its plain version at
    ``[2560, 200, 256]`` f32: 256 per-world scans from the simulator at
    random per-world poses (six on the edges), a third of the beams out
    to 5 m in a quarter of the worlds; in place and in lineage mode with
    block-diagonal ancestors, static and traced spacing.  Gates: maps
    equal by value, likelihood rtol 1e-5 / atol 1e-4, one launch for the
    fleet; a one-world call bitwise equal to the single-world call;
25. K2 on the flattened 2,560-map plan of a fleet resample against its
    plain version, bitwise, every copy inside its world block, with its
    time;
26. the main path of this slice: ``make_fused`` with bench.py's fleet
    values, 300 ticks of ``rollout_cadence`` at 256 worlds: K1 once per
    scan frame (in place), K2 at most once, finite outputs, every world's
    weights summing to 1, best-pose RMSE over every world and frame
    <= 0.15 m (``grid_slam.yaml``'s gate for 10 particles), the worst
    world printed beside it;
27. a 4-world fleet for 60 ticks under the same numpy draws on the card
    and on the CPU: best poses within 0.04 m RMSE, the frames whose
    ancestors differ printed;
28. other fleets: a tiled fleet (4 worlds x 64 particles, 6.4 x 12.8 m,
    K3 once per world a frame), ``grid_slam.yaml`` at 16 worlds (dda, no
    kernel), ``icp_test.yaml`` at 8 worlds (K4 once an iteration for all
    worlds; the worlds bitwise equal to each other, and within 2e-3 m of
    the single-world run of phase 14: batched products sum in another
    order) and ``landmarks.yaml`` at 8 worlds;
29. one copy-on-write and one whole-set-gather fleet update at 256 x 10
    under ``torch.cuda.set_sync_debug_mode("error")``;
30. times: K1 in place at the fleet shape (kernel, plain version, bound
    over the scan discs' cells), a warm 300-tick fleet run (world-ticks/s,
    bench.py's unit, and peak memory) and a profiled one (device busy
    time, idle share, launches per tick);

then the host graph (``graph/app.py``), each preset through
``App.from_file(..., device="cuda")`` frame by frame, the counts set to 0
just before each run and read just after, the published pose held
against the simulator's pose at the scan.  The App on the card runs
its nodes' device updates as captured CUDA graphs (the default
``capture=None``), so phases 31-44 hold their gates on the captured
path:

31. ``app_grid_slam_fused_300``: the headline preset at its full size
    (1,024 particles, bf16 ``[1024, 80, 128]``) for 300 frames: K1 once
    per SLAM update (lineage mode), K2, K3 and K4 never, RMSE <= 0.08 m,
    the published map ``[80, 80]``; frames/s, the median
    ``GridMapSlam::update`` span, K1 launches a frame, peak memory;
32. ``app_icp_test_900``: K4 ten times an update, RMSE <= 0.04 m, the
    first 300 frames again on the CPU within 2e-3 m at every update;
33. ``app_grid_slam_yaml_300`` (dda): the card and the CPU under the same
    numpy draws, best poses within 0.04 m RMSE, no kernel;
34. ``app_landmarks_300``: EKF RMSE <= 0.03 m, no kernel;
35. ``app_no_host_sync``: after frames that capture and replay every
    graph, 30 idle simulator ticks and one frame whose SLAM update
    publishes a pose and a map, every node update a replay, under
    ``torch.cuda.set_sync_debug_mode("error")``; then 60 frames of the
    captured ``landmarks.yaml`` App under ``"error"`` and 60 of
    ``icp_test.yaml`` under ``"warn"``, whose only syncs must be the ICP
    node's count read, once an update;
36. a profiled 300-frame App run of each preset: device busy time, idle
    share, CUDA launches a frame;
37. ``cli_run``: ``python -m slamrs_tpu_torch run
    configs/grid_slam_fused.yaml --duration 2 --npz`` in its own
    process: exit 0 and an ``[80, 80]`` ``slam/map`` in the file;
38. ``checkpoint_card``: ``rollout --save-state`` then ``--resume`` on
    the headline preset: the saved state equals the in-memory state of
    the same run bitwise (bf16 maps included) and round-trips bitwise,
    and 60 resumed ticks equal 60 ticks continued in memory.

then the robot I/O (the virtual robot, from ``(-1.0, -1.2, 0)`` in
``cmd_robot``'s scene, sent ``NeatoOn``, ``SetDownsampling{0}`` and
``Drive(0.10, 0.12)`` and stepped 15 s at 0.05 s, on the card and on the
CPU):

39. ``native_build``: ``g++`` builds ``slamrs_tpu_torch/native`` (its
    time); the native Neato parser bitwise the python path on the card
    robot's log, the native wire codec bitwise the python drain on a
    200-message stream cut at 40 random offsets;
40. ``virtual_robot_card_vs_cpu``: the same message count and kinds,
    odometry and rpm bitwise, valid masks equal, distances within 1 mm on
    fewer than 1e-3 of the valid beams;
41. ``replay_log``: ``python -m slamrs_tpu_torch replay`` on the card
    robot's log prints one frame fewer than the 75 revolutions written
    (the last is not closed by an index wrap);
42. ``app_neato_replay``: ``configs/neato_replay.yaml`` with ``path`` set
    through the App on the card until the FileLoader is done: one ICP
    update a frame of the log, K4 ten times an update and no other
    kernel, the ICP pose within 0.01 m RMSE of the robot's true pose in
    the first scan's frame (the JAX App gives 0.0017 m on the CPU,
    0.0166 m at its worst update),
    its position within 2e-3 m of the same replay on the CPU at every
    update (the heading difference reported beside it);
    frames/s, K4 launches a frame, peak memory; then a profiled run
    (idle share);
43. ``file_loader_no_host_sync``: 30 frames of a graph holding only the
    FileLoader under ``torch.cuda.set_sync_debug_mode("error")``;
44. ``robot_link_card``: ``python -m slamrs_tpu_torch robot`` in its own
    process, ``configs/neato_grid_slam.yaml`` at full size (dda, 10
    particles, ``[10, 400, 400]`` f32) connected to it over TCP and
    driven forward through ``!Controls``: at least 20 ScanOdometry
    messages and 20 dda updates within 60 s, never more updates than
    messages, no kernel, finite poses that move more than 0.05 m;
    ``terminate()`` returns and the robot process ends at ctrl-C with
    exit code 0 (its stderr printed); messages/s and the update span.

then sharded fleets (``slamrs_tpu_torch/parallel``): meshes whose
every entry is ``cuda:0`` (``make_mesh(n, particle_axis=k,
devices=[cuda:0] * n)``), each sharded run held against the one-device
run of the same world under the same seed, its world-ticks/s and own
peak memory printed beside the one-device run's (``mesh_phases_time``
says how long the phases took):

45. ``mesh_config5_*``: BASELINE config 5 (256 x 10 at 0.02 m, f32) for
    300 ticks on 8 x 1 (each world shard's flattened copy on write):
    bitwise the one-device fleet, K1 once per world shard a frame, K2 at
    most as often; on 4 x 2 (``"local"``, p_loc 5): RMSE <= 0.15 m, K1
    once per block a frame, one overflow read a frame;
46. ``mesh_headline_*``: 2 worlds x 1,024 particles at 0.05 m (bf16
    ``[80, 128]``) on 2 x 4: ``"gather"`` for 300 ticks bitwise the
    one-device fleet, K1 once per block a frame; ``"local"`` after one
    scan frame the per-world multiset of ``"gather"``, over 300 ticks
    RMSE <= 0.08 m, its overflow fallbacks counted (p_loc 256, spill
    cap 8);
47. ``mesh_config3_tiled_2x1_90``: two config-3 worlds (a 2.35 GB tile
    pool each) on 2 x 1 for 90 ticks: bitwise the one-device tiled
    fleet, K3 once per world a frame;
48. ``mesh_grid_slam_yaml_4x2_300`` (dda, 16 worlds, bitwise, no kernel),
    ``mesh_icp_test_4x1_300`` and ``mesh_landmarks_4x1_300`` (8 worlds:
    the RMSE gates of phases 14 and 15; ICP poses within 2e-3 m of the
    one-device fleet every frame, K4 ten times per world shard a frame;
    the EKF's gap printed);
49. ``mesh_dryrun_*``: the JAX package's ``dryrun_multichip(8)`` legs,
    one step each on an 8-entry mesh: dda (256 particles) and fused (64,
    bf16, ``"local"``) at 4 worlds on 2 x 4, tiled at config-3 geometry
    (8 particles) at 8 worlds on 8 x 1; dda and tiled bitwise the
    one-device step;
50. ``mesh_checkpoint``: a sharded 16-world config-5 fleet on 4 x 2
    saves the one-device layout's leaves, loads onto its mesh, and 60
    resumed ticks equal 60 continued ticks bitwise;
51. ``mesh_no_host_sync_*``: one update per mesh route under
    ``torch.cuda.set_sync_debug_mode("error")``, only the local
    relabel's overflow read (once a resample) let through.

Since PR 11 every ``rollout_cadence`` above on a one-device state runs
captured (``graph/capture.py``: one CUDA graph replay a scan frame), so
the gates above hold on the captured path (the meshes' too: their
entries are all the card).  Then the captured rollout against the eager
loop
(``capture_phases_time`` says how long they took):

52. ``capture_*``: on each route, fresh states, the eager loop
    (``capture=False``) beside the captured run (``capture=True``):
    headline lineage at 0.05 m (300 ticks) and 0.02 m (150), config 3
    tiled (K3) and copy on write (K1 in place + K2), gather (headline,
    K1 in place), ``grid_slam.yaml`` dda and dense, dda at the
    headline shape, ``icp_test.yaml`` (K4 ten times a frame),
    ``landmarks.yaml`` and the 256 x 10 fleet.  Gates: state and
    outputs bitwise under injected numpy draws and under the seed; the
    wrappers' launch counts equal the eager run's and the route's
    kernels a frame (K1/K2/K3 once, K4 ten times); the profiler's kernel
    names count the same; at least one graph replayed.  Printed beside
    the eager run's: graphs, capture seconds, bytes copied back a
    frame, host launch calls a frame (runtime launch, graph launch,
    memcpy and memset calls under the profiler; the eager profile over
    its first 10 frames), ticks/s (world-ticks/s), device busy time,
    idle share and each run's own peak memory;

then the App's node programs (``graph/capture.Program``, one per node;
``app_capture_phases_time`` says how long these took):

53. ``app_capture_*``: ``grid_slam_fused.yaml`` at its full size
    (1,024 particles, bf16 ``[1024, 80, 128]``, 300 frames),
    ``icp_test.yaml`` (900), ``grid_slam.yaml`` (dda, 300),
    ``landmarks.yaml`` (300) and ``neato_replay.yaml`` over the robot's
    log, each from fresh Apps with ``capture=False`` (op by op) and
    ``capture=True``.  Gates: every published message, every node state
    and the launch counts bitwise under injected numpy draws (the grid
    node's and the landmark sensor's seams) and under the seed; K1 once
    a grid update and K4 ten times an ICP update by counter and by the
    profiler's kernel names, no other kernel; every programmed node
    replaying.  Printed beside the op-by-op run's: frames/s, and over a
    profiled window after the graphs are captured host launch calls a
    frame, device busy time and idle share; per node its graphs,
    replays, capture seconds, launches a replay and bytes copied back a
    replay;
54. ``longrun_fused_vs_dda_500``: ``tests/torch_longrun.py`` on the
    card, 500 updates of dda (f32) and fused (bf16) through the grid
    node's captured update program under the JAX package's seed-7
    draws: ``tests/test_longrun.py``'s gates (tail drift <= 0.10 m dda,
    <= 0.15 m fused, path RMSE <= 0.10 m, occupancy agreement >= 0.80),
    the four numbers beside the JAX run's on the CPU, K1 once per fused
    update, 499 replays each.

A mesh whose entries are all the card runs captured too
(``capture=None``), so the ``mesh_*`` gates above hold on the captured
path; the local relabel's overflow read is one a frame.  Then the
sharded frames and the tick rollout as graphs
(``mesh_capture_phases_time`` says how long the mesh ones took):

55. ``mesh_capture_*``: the eager mesh rollout (``capture=False``) beside
    the captured one, fresh states, seed 0: config 5 on 8 x 1 and 4 x 2
    (``"local"``), the headline's 2 worlds on 2 x 4 (``"gather"`` and
    ``"local"``), two config-3 worlds tiled on 2 x 1 (90 ticks),
    ``grid_slam.yaml`` at 16 worlds on 4 x 2, ``icp_test.yaml`` and
    ``landmarks.yaml`` at 8 worlds on 4 x 1 (300 ticks).  Gates: state
    and outputs bitwise; the launch counts equal the eager run's and the
    route's kernels a frame (K1 once per block or world shard, K2 at
    most once per world shard, K3 once per world, K4 ten times per world
    shard); world-only, ``"gather"``, tiled and dda meshes one graph a
    frame with no overflow read; ``"local"`` one overflow read a frame
    (a head graph, each world row's branch graph, a tail graph); every
    frame after the first of its idle count a replay; the profiler's
    kernel names count the same over a 12-frame window.  Printed: K1-K4
    a frame, graphs and their keys, capture seconds, bytes copied back a
    frame, host launch calls a frame, idle share, world-ticks/s and peak
    memory, each beside the eager run's;
56. ``mesh_capture_no_host_sync_*``: the last frame of a captured rollout
    of each route above, a replay, under
    ``torch.cuda.set_sync_debug_mode("error")``, only the ``"local"``
    overflow read let through (once a frame);
57. ``rollout_tick_capture_*``: ``FusedWorld.rollout`` (one tick at a
    time) eager beside its tick programs (``capture=True``: an idle and
    a scan graph, the counterpart of ``jax.jit(fw.rollout)``) on the
    headline at 0.05 m, ``icp_test.yaml`` and ``landmarks.yaml`` for 300
    ticks: bitwise under injected draws and the seed, launches equal and
    the route's kernels a scan tick, host launch calls a tick and ticks/s
    beside the eager loop's.

The ``kernels`` line's entries carry the fleet runs' launches
(``fleet_launches``), for K1 and K2 their times at the fleet's shapes
(``fleet_ms``, ``fleet_plain_ms``, ``fleet_bound_ms``), and for K1 and
K4 the launches of the host-graph runs (``app_launches``) and of the
captured App runs of phase 53 (``app_capture_launches``), and for K4
those of the replay (``replay_launches``), for each kernel its
launches on the mesh runs (``mesh_launches``) and on the captured runs
of phase 52 by route (``captured_launches``), and on the captured mesh
and tick runs of phases 55 and 57 (``mesh_capture_launches``,
``tick_capture_launches``).

Every kernel's bound is the larger of the bytes it must move at
3.35 TB/s and its float32 operations at 67 TFLOP/s (the published H100
SXM peaks), from this run's inputs.  No cell outside the scan disc's box
(``ops/fused.cell_pass_box``, from this run's beams) changes, so an
update must touch only the box's cells inside the logical grid: fresh
output maps (K1 lineage mode) and privatized bands (K3) are moved whole,
maps updated in place only on the box, and operations count box cells.
The kernels compute that box widened to 16-byte columns (``box_cells``),
printed beside the window's cells with its cost at the same peaks
(``box_design_cost``).  The line before the last is the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

LIK_RTOL, LIK_ATOL = 1e-5, 1e-4
RMSE_GATE_M = 0.08
DEFERRED_GATE_M = 1e-5
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations per window cell of the fused update: ~40 arithmetic
# (offsets, r^2, sqrt, bin wrap, interval test, density) + ~20 for atan2
CELL_OPS = 60
CONFIG3 = (-25.0, -25.0, 50.0, 50.0, 0.05)
ICP_RMSE_GATE_M = 0.04
ICP_CPU_GATE_M = 2e-3
EKF_RMSE_GATE_M = 0.03
# float32 operations per (p, q) pair of K4: px*qx, py*qy, their sum, the
# doubling, the subtraction and the compare
NN_PAIR_OPS = 6
# float32 operations per source lane of one ICP solve iteration, an fma
# counted as two: the normal (8), e (5), dR p (8), J's third entry (3),
# the weight and w e (3), H's six entries (15), g (6), chi (1) and the
# source under the new pose (8)
ICP_SOLVE_LANE_OPS = 57
# bytes per source lane of one ICP solve iteration: corr, p, p_t and the
# mask read, three map points gathered, p_t written
ICP_SOLVE_LANE_BYTES = 4 + 8 + 8 + 1 + 24 + 8
# thread instructions the H100 SXM issues a second: 132 SMs x 4
# schedulers x 32 lanes at its 1.98 GHz boost clock
H100_ISSUE_SLOTS_PER_S = 132 * 128 * 1.98e9
YAML_SCRIPT = [[4.0, 0.05, 0.08], [8.0, 0.08, 0.05], [999.0, 0.06, 0.06]]
YAML_RECTS = [(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1),
              (-0.6, 0.4, 0.2, 0.5)]
YAML_LINES = [(-0.6, -0.4, 0.2, 0.4)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_info() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def kernel_case(torch, fused, spec, p, seed, num_beams, static, far=False):
    """Random inputs at the main path's shapes (made on the card); with
    ``far``, a third of the beams out to 5 m and poses on the edges."""
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rows, cols = spec.rows, (spec.cols + 127) // 128 * 128
    grids = torch.randn(p, rows, cols, generator=g, device=dev) * 2.0
    grids[torch.rand(p, rows, cols, generator=g, device=dev) < 0.3] = 0.0
    grids = grids.to(torch.bfloat16)
    lo = torch.tensor([-1.3, -1.3, -math.pi], device=dev)
    hi = torch.tensor([1.3, 1.3, math.pi], device=dev)
    poses = lo + (hi - lo) * torch.rand(p, 3, generator=g, device=dev)
    ancestors = torch.randint(0, p, (p,), generator=g, device=dev,
                              dtype=torch.int32)
    dist = 0.1 + 0.9 * torch.rand(num_beams, generator=g, device=dev)
    valid = torch.rand(num_beams, generator=g, device=dev) < 0.8
    present = torch.ones(num_beams, dtype=torch.bool, device=dev)
    if num_beams == 360:
        present[350:] = False
    else:  # partial sector: mixed present/valid flags
        present = torch.rand(num_beams, generator=g, device=dev) < 0.85
    if far:
        far_beams(torch, dist, g)
        edge_poses(poses, spec)
    dphi = math.radians(1.0) if static else \
        torch.tensor(math.radians(1.0), dtype=torch.float32, device=dev)
    angles0 = torch.tensor(0.1, dtype=torch.float32, device=dev)
    return (grids, poses, angles0, dist, valid, present, spec, num_beams,
            1.0), dict(ancestors=ancestors, dphi=dphi)


def far_beams(torch, dist, g):
    """A third of the beams out to 5 m: past the 1 m range and, at
    0.05 m cells, past the quantizer's cap of 511 x 0.125 cells."""
    dist[::3] = 1.0 + 4.0 * torch.rand(dist[::3].shape, generator=g,
                                       device=dist.device)


def edge_poses(poses, spec):
    """Six poses on the grid's column and row edges and corners."""
    x0, y0 = spec.position_x + 0.01, spec.position_y + 0.01
    x1 = spec.position_x + spec.width - 0.01
    y1 = spec.position_y + spec.height - 0.01
    poses[0, 0], poses[1, 0], poses[2, 1], poses[3, 1] = x0, x1, y0, y1
    poses[4, 0], poses[4, 1], poses[5, 0], poses[5, 1] = x0, y0, x1, y1


SCANS = ((360, False), (90, False), (360, True))  # (beams, far)


def check_kernel(torch, fused, spec, label):
    """Kernel against its plain version on the same inputs; returns the
    worst absolute error."""
    worst = 0.0
    for num_beams, far in SCANS:
        for static in (True, False):
            args, kw = kernel_case(torch, fused, spec, 1024, 7 + num_beams,
                                   num_beams, static, far)
            before = fused.fused_update.launches
            g_k, l_k = fused.fused_update(*args, **kw)
            torch.cuda.synchronize()
            if fused.fused_update.launches != before + 1:
                raise AssertionError("the launch counter did not count")
            g_p, l_p = fused.fused_update_reference(*args, **kw)
            diff = (g_k.float() - g_p.float()).abs()
            flip = float((diff > 0.01).float().mean())
            lik_err = float((l_k - l_p).abs().max())
            ok_lik = bool(torch.allclose(l_k, l_p, rtol=LIK_RTOL,
                                         atol=LIK_ATOL))
            worst = max(worst, float(diff.max()), lik_err)
            emit({"phase": f"kernel_vs_plain_{label}",
                  "shape": list(args[0].shape), "beams": num_beams,
                  "far": far, "dphi": "static" if static else "traced",
                  "flip_fraction": flip, "lik_max_abs_err": lik_err,
                  "grid_max_abs_err": float(diff.max())})
            if not (float(diff.max()) == 0.0 and ok_lik):
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version ({label}, {num_beams} beams, "
                                     f"far={far}, static={static})")
    return worst


def time_call(torch, fn, reps=20, warmup=3, hide_host=True) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings.

    With ``hide_host`` the card first spins ~20 ms, so the start event is
    reached only after the host has queued all of ``fn``'s work: the
    timing is then device time alone, without the host's launch gaps.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(40_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def headline_world(torch, resolution, integrate="fused",
                   grid_dtype="bfloat16"):
    """``make_fused`` with the ``configs/grid_slam_fused.yaml`` values
    (1,024 particles, 4 x 4 m, N_eff gate 0.5, scan every 0.2 s) at
    ``integrate``; the dda and dense maps are f32 and unpadded."""
    from slamrs_tpu_torch.graph.compile import make_fused
    from slamrs_tpu_torch.models.gridslam import GridSlamConfig
    from slamrs_tpu_torch.models.simulator import Scene, SimParams

    cfg = GridSlamConfig(position_x=-2.0, position_y=-2.0, width=4.0,
                         height=4.0, resolution=resolution, n_particles=1024,
                         max_scan_range=1.0, integrate=integrate,
                         resample_neff_frac=0.5, grid_dtype=grid_dtype)
    return make_fused(
        scene=Scene.build(rects=YAML_RECTS, lines=YAML_LINES, device="cuda"),
        params=SimParams.make(wheel_base=0.1, update_period=0.2,
                              scanner_range=1.0),
        grid_config=cfg, control_script=YAML_SCRIPT, device="cuda")


def counters():
    """The launch counters of every kernel wrapper, by name."""
    from slamrs_tpu_torch.graph.capture import launch_counters

    return launch_counters()


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    from slamrs_tpu_torch.graph.capture import launch_counts

    return launch_counts()


def slam_counts(counts):
    """``counts`` but the simulator kernel's, which every world and App
    with a simulator launches."""
    return {k: v for k, v in counts.items() if k != "sim_frame"}


def sim_launches(fw, n_steps, rows=1) -> int:
    """The simulator kernel's launches in a cadence rollout of
    ``n_steps`` ticks from a fresh state: one a scan frame and one for
    the trailing idle ticks, on each of ``rows`` world shards."""
    fires = fw.fire_schedule(n_steps, 0.0)[0]
    return rows * (len(fires) + int(fires[-1] < n_steps - 1))


def sim_ticks(app) -> int:
    """The ticks the App's simulator has run: one simulator kernel each."""
    from slamrs_tpu_torch.graph.nodes.sim import SimulatorNode

    return app.node(SimulatorNode).ticks


def check_rollout(torch, fw, n_steps, label, rmse_gate=None, expect=None):
    """Drive ``fw.rollout_cadence`` with every launch count set to 0 just
    before and read just after.  ``expect`` maps counter names to
    ``"frames"`` or a number (default: K1 once per frame)."""
    expect = expect or {"fused_update": "frames"}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = fw.rollout_cadence(fw.init(), n_steps, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["fused_update"]
    frames = int(outs.fired.shape[0])
    err = outs.grid_pose[:, :2] - outs.pose[:, :2]
    rmse = float(torch.sqrt((err ** 2).mean()))
    wsum = float(state.grid.weights.sum())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (
        outs.pose, outs.grid_pose, outs.n_eff, state.grid.weights,
        state.grid.poses, state.grid.grids))
    emit({"phase": f"rollout_{label}", "ticks": n_steps, "frames": frames,
          "launches": launches, "launch_counts": counts,
          "grid_pose_rmse_xy_m": rmse,
          "weights_sum": wsum, "finite": finite,
          "grids": list(state.grid.grids.shape),
          "tile_table": (None if state.grid.tile_table is None
                         else list(state.grid.tile_table.shape)),
          "seconds": seconds})
    for name, want in expect.items():
        want = frames if want == "frames" else want
        if counts[name] != want:
            raise AssertionError(f"{label}: {counts[name]} {name} launches, "
                                 f"expected {want} ({frames} frames)")
    if not finite or abs(wsum - 1.0) > 1e-5:
        raise AssertionError("non-finite outputs or weights not normalized")
    if rmse_gate is not None and not rmse <= rmse_gate:
        raise AssertionError(f"grid pose RMSE {rmse} m > {rmse_gate} m")
    return counts, outs, state


def fused_bound(nbytes, cells):
    """(ms, bound_by) of a fused update moving ``nbytes`` and computing
    ``cells`` cells: the larger of the two times at the card's peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = cells * CELL_OPS / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def disc_extent(torch, spec, prep, cols):
    """Per particle, the scan disc's box (``ops/fused.cell_pass_box``, the
    same definition the kernels compute) clipped to the logical grid:
    first map row, end row (exclusive) and column count.  No cell outside
    it can change, so it is what an update must touch."""
    from slamrs_tpu_torch.ops import fused

    y0, y1, x0, x1 = (v.long() for v in fused.cell_pass_box(prep, cols))
    r0 = prep.r0.long()
    top = r0 + y0
    end = torch.maximum(torch.clamp(r0 + y1, max=spec.rows), top)
    ncols = (torch.clamp(x1, max=spec.cols) - x0).clamp_min(0)
    return top, end, ncols


def disc_cells(torch, spec, prep, cols):
    y0, y1, ncols = disc_extent(torch, spec, prep, cols)
    return int(((y1 - y0) * ncols).sum())


def box_cells(torch, prep, cols, elem_bytes):
    """Cells the kernels' box pass computes: the box widened to 16-byte
    columns."""
    from slamrs_tpu_torch.ops import fused

    y0, y1, x0, x1 = fused.cell_pass_box(prep, cols, 16 // elem_bytes)
    return int(((y1 - y0).long() * (x1 - x0).long()).sum())


def cow_bytes(torch, grids, src, n_copies):
    """Bytes a copy plan must move: each unique source map read once,
    each copy written once."""
    n = int(n_copies)
    map_bytes = grids[0].numel() * grids.element_size()
    return (int(torch.unique(src[:n]).numel()) + n) * map_bytes


def config3_maps(torch, seed):
    """``[1024, 1000, 1024]`` bf16 maps of random log-odds, made on the
    card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    grids = torch.empty(1024, 1000, 1024, dtype=torch.bfloat16,
                        device="cuda")
    for c in range(0, 1024, 128):  # bounded f32 temporaries
        grids[c:c + 128] = torch.randn(grids[c:c + 128].shape, generator=g,
                                       device="cuda") * 2.0
    grids[:, :, 1000:] = 0.0
    return grids


def cow_plans(torch):
    """bench.py's config-3 plan (512 copies of 256 unique maps), a
    systematic resample of peaked weights, and the identity plan."""
    from slamrs_tpu_torch.ops import resample

    p, k = 1024, 512
    uniq = k // 2
    bench = torch.arange(p, device="cuda")
    bench[p - k:] = torch.arange(k, device="cuda") % uniq
    bench = torch.sort(bench)[0].to(torch.int32)
    g = torch.Generator(device="cuda").manual_seed(5)
    w = torch.softmax(torch.randn(p, generator=g, device="cuda") * 4.0, 0)
    peaked = resample.systematic_resample(
        w, torch.rand(1, generator=g, device="cuda"))
    return {"bench": bench, "systematic_peaked": peaked,
            "identity": torch.arange(p, dtype=torch.int32, device="cuda")}


def compare_dense(a, b, chunk=128):
    """(flip fraction, max |diff|) of two dense map sets, compared
    ``chunk`` particles at a time to bound the float32 temporaries."""
    flips = cells = 0
    worst = 0.0
    for c in range(0, a.shape[0], chunk):
        diff = (a[c:c + chunk].float() - b[c:c + chunk].float()).abs()
        flips += int((diff > 0.01).sum())
        cells += diff.numel()
        worst = max(worst, float(diff.max()))
    return flips / cells, worst


def check_cow(torch):
    """K2 against its plain version on the config-3 map set; bitwise.
    Returns the largest absolute difference (0 when bitwise equal)."""
    from slamrs_tpu_torch.ops import cow

    grids = config3_maps(torch, 21)
    worst = 0.0
    for label, anc in cow_plans(torch).items():
        src, dst, n = cow.cow_plan(anc)
        g_k = grids.clone()
        before = cow.cow_copy.launches
        cow.cow_copy(g_k, src, dst, n)
        torch.cuda.synchronize()
        if cow.cow_copy.launches != before + 1:
            raise AssertionError("the cow_copy launch counter did not count")
        g_p = cow.cow_copy_reference(grids.clone(), src, dst, n)
        equal = bool(torch.equal(g_k, g_p))
        err = compare_dense(g_k, g_p)[1]
        worst = max(worst, err)
        moved = bool(not torch.equal(g_k, grids)) if int(n) else False
        emit({"phase": "kernel_vs_plain_cow_config3", "plan": label,
              "shape": list(grids.shape), "n_copies": int(n),
              "bitwise_equal": equal, "max_abs_err": err,
              "maps_changed": moved})
        if not equal or (int(n) > 0) != moved:
            raise AssertionError(f"cow_copy disagrees with its plain version "
                                 f"({label})")
        del g_k, g_p
    return worst


def tiled_pool(torch, tiles, spec, p, seed):
    """A tiled state at ``spec`` with random log-odds (~30 % zeros, zero
    column tail) and a random table that shares tiles."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool, table = tiles.init_tiled(p, spec, 1.0, device="cuda")
    for c in range(0, pool.shape[0], 2048):
        blk = torch.randn(pool[c:c + 2048].shape, generator=g,
                          device="cuda") * 2.0
        blk[torch.rand(blk.shape, generator=g, device="cuda") < 0.3] = 0.0
        pool[c:c + 2048] = blk
    pool[:, :, spec.cols:] = 0.0
    table.copy_(torch.randint(0, table.numel(), table.shape, generator=g,
                              device="cuda", dtype=torch.int32))
    return pool, table


def tiled_step_inputs(torch, spec, p, g, num_beams, static, far=False):
    """Poses across the map (two pinned to the y-edges), a scan, and a
    sorted pending lineage; with ``far``, a third of the beams out to 5 m
    and six poses on the column and row edges."""
    lo = torch.tensor([spec.position_x + 0.3, spec.position_y + 0.3, -math.pi],
                      device="cuda")
    ext = torch.tensor([spec.width - 0.6, spec.height - 0.6, 2 * math.pi],
                       device="cuda")
    poses = lo + ext * torch.rand(p, 3, generator=g, device="cuda")
    poses[0, 1] = spec.position_y + 0.01
    poses[1, 1] = spec.position_y + spec.height - 0.01
    dist = 0.1 + 0.9 * torch.rand(num_beams, generator=g, device="cuda")
    valid = torch.rand(num_beams, generator=g, device="cuda") < 0.8
    if num_beams == 360:
        present = torch.ones(num_beams, dtype=torch.bool, device="cuda")
        present[350:] = False
    else:
        present = torch.rand(num_beams, generator=g, device="cuda") < 0.85
    if far:
        far_beams(torch, dist, g)
        edge_poses(poses, spec)
    dphi = math.radians(1.0) if static else \
        torch.tensor(math.radians(1.0), dtype=torch.float32, device="cuda")
    anc = torch.sort(torch.randint(0, p, (p,), generator=g, device="cuda",
                                   dtype=torch.int32))[0]
    a0 = torch.tensor(0.1, dtype=torch.float32, device="cuda")
    return (poses, a0, dist, valid, present, spec, num_beams, 1.0), dphi, anc


def compare_tiled(torch, tiles, pool_a, table_a, pool_b, table_b, spec):
    """(flip fraction, max |diff|, tail is zero) of two tiled states'
    materialized maps, compared 128 particles at a time."""
    flips = cells = 0
    worst = 0.0
    tail_zero = True
    for c in range(0, table_a.shape[0], 128):
        a = tiles.materialize(pool_a, table_a[c:c + 128], spec).float()
        b = tiles.materialize(pool_b, table_b[c:c + 128], spec).float()
        diff = (a - b).abs()
        flips += int((diff > 0.01).sum())
        cells += diff.numel()
        worst = max(worst, float(diff.max()))
        tail_zero &= not bool(a[:, :, spec.cols:].any())
    return flips / cells, worst, tail_zero


def check_tiled(torch, spec, label, n_updates=3):
    """K3 against its plain version over ``n_updates`` updates with
    lineage relabels; returns the worst absolute error."""
    from slamrs_tpu_torch.ops import tiles

    worst = 0.0
    for num_beams, far in SCANS:
        for static in (True, False):
            g = torch.Generator(device="cuda").manual_seed(31 + num_beams)
            pool_k, table_k = tiled_pool(torch, tiles, spec, 1024, 41)
            pool_p, table_p = pool_k.clone(), table_k
            kspan = tiles.span_of(spec, 1.0, pool_k.shape[1])
            for step in range(n_updates):
                args, dphi, anc = tiled_step_inputs(torch, spec, 1024, g,
                                                    num_beams, static, far)
                before = tiles.fused_update_tiled.launches
                _, table_k, l_k = tiles.fused_update_tiled(
                    pool_k, table_k, *args, dphi=dphi, ancestors=anc)
                torch.cuda.synchronize()
                if tiles.fused_update_tiled.launches != before + 1:
                    raise AssertionError("the tiled launch counter did not "
                                         "count")
                st = tiles.plan_step(pool_p, table_p, *args, dphi=dphi,
                                     ancestors=anc)
                l_p = tiles.fused_update_tiled_reference(
                    pool_p, st.src, st.dst, st.woff, st.prep, spec,
                    num_beams)
                table_p = st.new_table
                flip, grid_err, tail_zero = compare_tiled(
                    torch, tiles, pool_k, table_k, pool_p, table_p, spec)
                lik_err = float((l_k - l_p).abs().max())
                ok = (grid_err == 0.0 and tail_zero
                      and bool(torch.equal(table_k, table_p))
                      and bool(torch.allclose(l_k, l_p, rtol=LIK_RTOL,
                                              atol=LIK_ATOL)))
                worst = max(worst, grid_err, lik_err)
                emit({"phase": f"kernel_vs_plain_tiled_{label}",
                      "pool": list(pool_k.shape),
                      "table": list(table_k.shape), "kspan": kspan,
                      "beams": num_beams, "far": far,
                      "dphi": "static" if static else "traced",
                      "update": step, "flip_fraction": flip,
                      "grid_max_abs_err": grid_err,
                      "lik_max_abs_err": lik_err,
                      "fresh_tiles": int((st.dst != st.src).sum()),
                      "tail_zero": tail_zero})
                if not ok:
                    raise AssertionError(f"tiled kernel disagrees with its "
                                         f"plain version ({label}, "
                                         f"{num_beams} beams, far={far}, "
                                         f"static={static}, update {step})")
            del pool_k, pool_p
    return worst


def check_k3_vs_k1(torch, spec, far):
    """On the same config-3 inputs (``far``: beams past the range, poses
    on the edges): K1 (lineage mode, and in place on the relabelled maps)
    against its plain version, maps equal by value and the likelihood
    gate, then K3 on the tiled state against both K1 modes on the
    materialized maps, bitwise; with ``far`` only where the dense and
    tiled windows start on the same row.  Returns K1's worst absolute
    error against its plain version."""
    from slamrs_tpu_torch.ops import fused, tiles

    g = torch.Generator(device="cuda").manual_seed(51)
    pool, table = tiled_pool(torch, tiles, spec, 1024, 52)
    args, dphi, anc = tiled_step_inputs(torch, spec, 1024, g, 360, True, far)
    dense = tiles.materialize(pool, table, spec).contiguous()
    g_lin, l_lin = fused.fused_update(dense, *args, ancestors=anc, dphi=dphi)
    p_lin, pl_lin = fused.fused_update_reference(dense, *args, dphi=dphi,
                                                 ancestors=anc)
    del dense
    dense = tiles.materialize(pool, table[anc.long()], spec).contiguous()
    p_in, pl_in = fused.fused_update_reference(dense.clone(), *args,
                                               dphi=dphi, in_place=True)
    g_in, l_in = fused.fused_update(dense, *args, dphi=dphi, in_place=True)
    worst = 0.0
    for mode, g_k, l_k, g_p, l_p in (("lineage", g_lin, l_lin, p_lin, pl_lin),
                                     ("in_place", g_in, l_in, p_in, pl_in)):
        flip, grid_err = compare_dense(g_k, g_p)
        lik_err = float((l_k - l_p).abs().max())
        ok_lik = bool(torch.allclose(l_k, l_p, rtol=LIK_RTOL, atol=LIK_ATOL))
        worst = max(worst, grid_err, lik_err)
        emit({"phase": "kernel_vs_plain_k1_config3", "mode": mode,
              "far": far, "shape": list(g_k.shape), "flip_fraction": flip,
              "grid_max_abs_err": grid_err, "lik_max_abs_err": lik_err})
        if not (grid_err == 0.0 and ok_lik):
            raise AssertionError(f"K1 ({mode}) disagrees with its plain "
                                 f"version at config 3 (far={far})")
    del p_lin, p_in
    same = fused.prepare(spec.rows, g_lin.shape[2], *args[:5], spec, 360,
                         1.0, dphi).r0 == tiles.plan_step(
        pool, table, *args, dphi=dphi, ancestors=anc).prep.r0
    if not far:
        same[:] = True
    _, table_k, l_k = tiles.fused_update_tiled(pool, table, *args, dphi=dphi,
                                               ancestors=anc)
    torch.cuda.synchronize()
    maps_equal = True
    for c in range(0, 1024, 128):
        m = tiles.materialize(pool, table_k[c:c + 128], spec)
        sel = same[c:c + 128]
        maps_equal &= bool(torch.equal(m[sel], g_lin[c:c + 128][sel]))
        maps_equal &= bool(torch.equal(m[sel], g_in[c:c + 128][sel]))
    lik_equal = bool(torch.equal(l_k[same], l_lin[same])
                     and torch.equal(l_k[same], l_in[same]))
    emit({"phase": "k3_vs_k1_config3", "far": far,
          "maps_bitwise_equal": maps_equal,
          "lik_equal": lik_equal, "maps": list(g_lin.shape),
          "particles_compared": int(same.sum()),
          "pool": list(pool.shape)})
    if not (maps_equal and lik_equal):
        raise AssertionError(f"K3 and K1 disagree on the same inputs "
                             f"(far={far})")
    return worst


def config3_world(torch, **grid_kw):
    from slamrs_tpu_torch.graph.compile import make_fused
    from slamrs_tpu_torch.models.gridslam import GridSlamConfig
    from slamrs_tpu_torch.models.simulator import Scene, SimParams

    x, y, w, h, res = CONFIG3
    cfg = GridSlamConfig(position_x=x, position_y=y, width=w, height=h,
                         resolution=res, n_particles=1024,
                         max_scan_range=1.0, integrate="fused",
                         resample_neff_frac=0.5, grid_dtype="bfloat16",
                         **grid_kw)
    return make_fused(
        scene=Scene.build(rects=YAML_RECTS, lines=YAML_LINES, device="cuda"),
        params=SimParams.make(wheel_base=0.1, update_period=0.2,
                              scanner_range=1.0),
        grid_config=cfg, control_script=YAML_SCRIPT, device="cuda")


def check_config3_rollouts(torch):
    """Auto (tiled), pinned deferred, and copy on write, 300 ticks each;
    returns the launch counts of the tiled and copy-on-write runs."""
    tiled_counts, tiled_outs, state = check_rollout(
        torch, config3_world(torch), 300, "config3_tiled_300", RMSE_GATE_M,
        expect={"fused_update_tiled": "frames", "fused_update": 0,
                "cow_copy": 0})
    if state.grid.tile_table is None:
        raise AssertionError("config 3 under auto did not store tiled maps")
    del state
    _, deferred_outs, state = check_rollout(
        torch, config3_world(torch, resample_cow="staged",
                             fused_resident=True),
        300, "config3_deferred_300", RMSE_GATE_M,
        expect={"fused_update": "frames", "fused_update_in_place": 0,
                "fused_update_tiled": 0, "cow_copy": 0})
    del state
    gap = float((tiled_outs.grid_pose - deferred_outs.grid_pose).abs().max())
    emit({"phase": "config3_tiled_vs_deferred", "max_best_pose_diff_m": gap})
    if not gap <= DEFERRED_GATE_M:
        raise AssertionError(f"tiled and deferred config-3 runs differ by "
                             f"{gap} m")
    cow_counts, _, state = check_rollout(
        torch, config3_world(torch, resample_cow=True), 300,
        "config3_cow_300", RMSE_GATE_M,
        expect={"fused_update_in_place": "frames", "fused_update": "frames",
                "cow_copy": "frames", "fused_update_tiled": 0})
    del state
    return tiled_counts, cow_counts


def check_no_host_sync(torch):
    """The plans and one tiled config-3 update never wait for the card."""
    from slamrs_tpu_torch.core.types import OdometryReading
    from slamrs_tpu_torch.models import gridslam as gs
    from slamrs_tpu_torch.models.simulator import lidar_scan
    from slamrs_tpu_torch.ops import cow, tiles

    fw = config3_world(torch)
    st = fw.init().grid
    pose = torch.tensor([0.1, -0.2, 0.3], device="cuda")
    scan = lidar_scan(pose, fw.scene, 1.0, 360)
    odo = OdometryReading(torch.full((), 0.01, device="cuda"),
                          torch.full((), 0.012, device="cuda"),
                          fw.params.wheel_base)
    gen = torch.Generator(device="cuda").manual_seed(3)
    anc = cow_plans(torch)["bench"]
    t0 = torch.zeros(1024, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cow.cow_plan(anc)
        tiles.tiled_plan(st.tile_table, t0, st.grids.shape[0])
        st, out = gs.update(st, scan, odo, fw.grid_config, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit({"phase": "no_host_sync_plans", "ok": True,
          "pose_finite": bool(torch.isfinite(out.pose).all())})


def time_config3(torch):
    """Device times at config 3: K2, its plain version and the library
    yardstick on bench.py's plan; K3 and its plain version after one
    resample; K1 in place.  Returns the kernels-line numbers."""
    from slamrs_tpu_torch.ops import cow, fused, tiles

    spec = _spec(CONFIG3)
    out = {}
    grids = config3_maps(torch, 61)
    src, dst, n = cow.cow_plan(cow_plans(torch)["bench"])
    n_host = n.cpu()
    nbytes = cow_bytes(torch, grids, src, n)
    ms = time_call(torch, lambda: cow.launch_kernel(grids, src, dst, n))
    plain_ms = time_call(torch, lambda: cow.cow_copy_reference(
        grids, src, dst, n_host))
    s_l, d_l = src.long(), dst.long()
    lib_ms = time_call(torch, lambda: grids.index_copy_(
        0, d_l, grids.index_select(0, s_l)))
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    out["cow_copy"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, bound_by="bytes")
    emit({"phase": "kernel_time_cow_config3", "n_copies": int(n),
          "bytes": nbytes, "kernel_ms": ms, "plain_ms": plain_ms,
          "index_copy_ms": lib_ms, "bound_ms": bound,
          "kernel_tb_per_s": nbytes / ms / 1e9, "peak_tb_per_s": 3.35})

    # K1 in place on the dense config-3 maps
    g = torch.Generator(device="cuda").manual_seed(62)
    args, dphi, _ = tiled_step_inputs(torch, spec, 1024, g, 360, True)
    prep = fused.prepare(1000, 1024, *args[:5], spec, 360, 1.0, dphi)
    k1_ms = time_call(torch, lambda: fused.launch_kernel(grids, None, prep,
                                                          spec, 360))
    k1_plain = time_call(torch, lambda: fused.plain_update(grids, prep, spec,
                                                           360))
    # in place only the disc's cells change: read and write them once; the
    # kernel reads and writes its box
    el = grids.element_size()
    cells = disc_cells(torch, spec, prep, grids.shape[2])
    k1_bound, k1_by = fused_bound(2 * cells * el, cells)
    window = 1024 * prep.wr * grids.shape[2]
    box = box_cells(torch, prep, grids.shape[2], el)
    emit({"phase": "kernel_time_k1_in_place_config3",
          "shape": list(grids.shape), "kernel_ms": k1_ms,
          "plain_ms": k1_plain, "disc_cells": cells, "bound_ms": k1_bound,
          "bound_by": k1_by, "window_cells": window, "box_cells": box,
          "box_design_cost_ms": fused_bound(2 * box * el, box)[0],
          "g_box_cells_per_s": box / k1_ms / 1e6})
    if box * 10 > window:
        raise AssertionError(f"config-3 box of {box} cells exceeds a tenth "
                             f"of the window's {window}")
    del grids

    # K3 after one resample: a real update from the zero pool privatizes
    # every touched band, a bench-like relabel shares half the rows again
    # (the poses follow the lineage: a particle with one child writes in
    # place, one with several gets fresh tiles)
    pool, table = tiles.init_tiled(1024, spec, 1.0, device="cuda")
    args, dphi, _ = tiled_step_inputs(torch, spec, 1024, g, 360, True)
    _, table, _ = tiles.fused_update_tiled(pool, table, *args, dphi=dphi)
    anc = cow_plans(torch)["bench"]
    st = tiles.plan_step(pool, table, args[0][anc.long()], *args[1:],
                         dphi=dphi, ancestors=anc)
    ms = time_call(torch, lambda: tiles.launch_kernel(pool, st, spec, 360))
    pool_p = pool.clone()
    plain_ms = time_call(torch, lambda: tiles.fused_update_tiled_reference(
        pool_p, st.src, st.dst, st.woff, st.prep, spec, 360))
    # what the function must move: a privatized band is read and written
    # whole; an owned band only where the scan disc overlaps it
    hb, cols, wr = pool.shape[1], pool.shape[2], st.prep.wr
    el = pool.element_size()
    fresh = st.dst != st.src
    band0 = ((st.prep.r0 - st.woff).long()[:, None]
             + torch.arange(st.src.shape[1], device="cuda")[None, :] * hb)

    def band_bytes(y0, y1, ncols):
        overlap = (torch.minimum(y1[:, None], band0 + hb)
                   - torch.maximum(y0[:, None], band0)).clamp_min(0)
        return int(torch.where(fresh, hb * cols, overlap * ncols[:, None])
                   .sum()) * el * 2

    y0, y1, ncols = disc_extent(torch, spec, st.prep, cols)
    nbytes = band_bytes(y0, y1, ncols)
    cells = int(((y1 - y0) * ncols).sum())
    bound, by = fused_bound(nbytes, cells)
    # the design reads and writes the box widened to 16-byte columns where
    # the band is owned
    by0, by1, bx0, bx1 = (v.long() for v in fused.cell_pass_box(
        st.prep, cols, 16 // el))
    r0 = st.prep.r0.long()
    design_bytes = band_bytes(r0 + by0, r0 + by1, bx1 - bx0)
    box = box_cells(torch, st.prep, cols, el)
    window = 1024 * wr * cols
    out["fused_update_tiled"] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=None, bound_ms=bound,
                                     bound_by=by)
    emit({"phase": "kernel_time_tiled_config3", "pool": list(pool.shape),
          "fresh_tiles": int(fresh.sum()), "bytes": nbytes,
          "disc_cells": cells, "kernel_ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": by,
          "design_bytes": design_bytes, "window_cells": window,
          "box_cells": box,
          "box_design_cost_ms": fused_bound(design_bytes, box)[0],
          "kernel_tb_per_s_of_design_bytes": design_bytes / ms / 1e9,
          "peak_tb_per_s": 3.35, "g_box_cells_per_s": box / ms / 1e6})
    return out


def time_config3_rollouts(torch):
    """Warm 900-tick config-3 runs, tiled and copy on write."""
    for label, kw in (("tiled", {}), ("cow", {"resample_cow": True})):
        fw = config3_world(torch, **kw)
        fw.rollout_cadence(fw.init(), 30, seed=2)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, outs = fw.rollout_cadence(fw.init(), 900, seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        err = outs.grid_pose[:, :2] - outs.pose[:, :2]
        emit({"phase": f"rollout_time_config3_{label}_900", "ticks": 900,
              "frames": int(outs.fired.shape[0]), "seconds": seconds,
              "ticks_per_s": 900 / seconds,
              "grid_pose_rmse_xy_m": float(torch.sqrt((err ** 2).mean())),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
        del state, outs


def profile_rollout(torch, fw, label, n_steps=300, kernel=None, worlds=()):
    """Device busy time, idle share and launches of a profiled run (of
    ``worlds`` worlds); with ``kernel``, the device time and launches of
    the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, outs = fw.rollout_cadence(fw.init(worlds), n_steps, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_s = sum(e.self_device_time_total for e in device) / 1e6
    top = max(device, key=lambda e: e.self_device_time_total)
    extra = {}
    if kernel is not None:
        mine = [e for e in device if kernel in e.key]
        extra = {f"{kernel}_s": sum(e.self_device_time_total
                                    for e in mine) / 1e6,
                 f"{kernel}_launches": sum(e.count for e in mine),
                 "frames": int(outs.fired.shape[0])}
    emit({"phase": f"profile_{label}", "wall_s_profiled": wall,
          "device_busy_s": device_s, "idle_share": 1 - device_s / wall,
          "kernel_launches": sum(e.count for e in device),
          "launches_per_tick": sum(e.count for e in device) / n_steps,
          "top_kernel": top.key[:60], "top_kernel_s":
          top.self_device_time_total / 1e6, "top_kernel_count": top.count,
          **extra})


def bench_icp_inputs(torch, batch=2048, beams=360):
    """bench.py's ICP problems (bench.py:122-132) on the card: a ring of
    360 points with radii U(0.5, 1.0) per problem, p = q + U(+-0.05)."""
    import numpy as np

    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, beams, endpoint=False)
    q = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    q = q * rng.uniform(0.5, 1.0, (beams, 1)).astype(np.float32)
    qb = np.tile(q[None], (batch, 1, 1))
    dx = rng.uniform(-0.05, 0.05, (batch, 1, 2)).astype(np.float32)
    pb = (q[None] + dx).astype(np.float32)
    return (torch.from_numpy(pb).cuda(), torch.from_numpy(qb).cuda(),
            torch.full((batch,), beams, dtype=torch.int32, device="cuda"))


def nn_cases(torch):
    """K4's input sets: label -> (p [B, Np, 2], q [B, Nq, 2], q_count)."""
    g = torch.Generator(device="cuda").manual_seed(71)
    cases = {"bench_2048x360x360": bench_icp_inputs(torch)}
    p = torch.rand(1, 360, 2, generator=g, device="cuda") * 2 - 1
    q = torch.rand(1, 16384, 2, generator=g, device="cuda") * 2 - 1
    # the mapper's q split is 44 chunks of ceil(q_count / 44) lanes (at
    # most 373): counts around both edges
    for qc in (0, 1, 43, 44, 45, 360, 372, 373, 374, 10000, 16384):
        cases[f"mapper_1x360x16384_qc{qc}"] = (
            p, q, torch.full((1,), qc, dtype=torch.int32, device="cuda"))
    base = torch.rand(4, 96, 2, generator=g, device="cuda") * 2 - 1
    dup = base.repeat_interleave(4, dim=1)  # each point four times
    cases["duplicates_4x360x384"] = (
        torch.rand(4, 360, 2, generator=g, device="cuda") * 2 - 1, dup,
        torch.full((4,), 384, dtype=torch.int32, device="cuda"))
    # 512 points 32 times over: every point's copies in other chunks
    tied = (torch.rand(1, 512, 2, generator=g, device="cuda") * 2 - 1
            ).repeat(1, 32, 1)
    p_tied = p.clone()
    p_tied[:, ::3] = tied[:, 5:125]
    cases["ties_across_chunks_1x360x16384"] = (
        p_tied, tied, torch.full((1,), 16384, dtype=torch.int32,
                                 device="cuda"))
    p4 = torch.rand(4, 360, 2, generator=g, device="cuda") * 2 - 1
    q4 = torch.rand(4, 1000, 2, generator=g, device="cuda") * 2 - 1
    ragged = torch.tensor([1000, 999, 37, 1], dtype=torch.int32,
                          device="cuda")
    cases["negative_4x360x1000"] = (p4 * 10.0, q4, ragged)
    cases["tiny_4x360x1000"] = (p4 * 1e-20, q4 * 1e-20, ragged)
    vals = torch.tensor([0.0, -0.0, 1.0, -1.0], device="cuda")
    cases["signed_zero_4x360x1000"] = (
        vals[torch.randint(0, 4, p4.shape, generator=g, device="cuda")],
        vals[torch.randint(0, 4, q4.shape, generator=g, device="cuda")],
        ragged)
    for n_p in (1, 33, 361):
        cases[f"np{n_p}_4x{n_p}x1000"] = (
            torch.rand(4, n_p, 2, generator=g, device="cuda") * 2 - 1, q4,
            torch.tensor([1000, 500, 3, 0], dtype=torch.int32,
                         device="cuda"))
    far = torch.tensor([1000.0, -2000.0], device="cuda")
    cases["far_8x360x4096"] = (
        far + torch.rand(8, 360, 2, generator=g, device="cuda"),
        far + torch.rand(8, 4096, 2, generator=g, device="cuda"),
        torch.tensor([4096, 4000, 3000, 2048, 1000, 100, 7, 4096],
                     dtype=torch.int32, device="cuda"))
    return cases


def check_nn(torch):
    """K4 against its plain version on every input set: indices bitwise.
    Returns the largest index difference (0 when all are equal)."""
    from slamrs_tpu_torch.ops import icp

    worst = 0
    for label, (p, q, qc) in nn_cases(torch).items():
        before = icp.nearest_neighbors_fused.launches
        got = icp.nearest_neighbors_fused(p, q, qc)
        torch.cuda.synchronize()
        if icp.nearest_neighbors_fused.launches != before + 1:
            raise AssertionError("the nn_argmin launch counter did not count")
        want = icp.nearest_neighbors_reference(p, q, qc)
        diff = int((got.long() - want.long()).abs().max())
        worst = max(worst, diff)
        q2 = (q * q).sum(-1)
        d2_min = float((q2[:, None, :] - 2 * p @ q.transpose(1, 2)).min())
        extra = {}
        if label.startswith("duplicates"):  # the first copy always wins
            extra["first_copy_wins"] = bool((got % 4 == 0).all())
        if label.startswith("ties_across_chunks"):
            extra["first_copy_wins"] = bool((got < 512).all())
        emit({"phase": "kernel_vs_plain_nn", "case": label,
              "p": list(p.shape), "q": list(q.shape),
              "q_count": qc.tolist()[:8], "bitwise_equal": diff == 0,
              "mismatches": int((got != want).sum()),
              "min_d2": d2_min, **extra})
        if diff != 0 or not extra.get("first_copy_wins", True):
            raise AssertionError(f"nn_argmin disagrees with its plain "
                                 f"version ({label})")
    return worst


def icp_solve_cases(torch):
    """The ICP solve kernel's input sets: label -> (p, mask, q, q_count,
    pose, Step threshold).  The ICP mapper's (one problem of 360 lanes
    against a full 16,384-point map of an ordered closed curve, Step
    0.05, ~12 % of the lanes masked, the pose 2 cm and 0.03 rad off) and
    bench.py's batch ([2048, 360] against 360-point rings, uniform
    weights)."""
    import math

    g = torch.Generator().manual_seed(7)
    n_map, beams = 16384, 360
    ang = torch.sort(torch.rand(1, n_map, generator=g) * 2 * math.pi)[0]
    r = 0.8 + 0.15 * torch.sin(3 * ang)
    q = torch.stack([r * torch.cos(ang), r * torch.sin(ang)], -1).cuda()
    p = q[:, ::n_map // beams][:, :beams].contiguous()
    mask = (torch.rand(1, beams, generator=g) > 0.12).cuda()
    qc = torch.full((1,), n_map, dtype=torch.int32, device="cuda")
    x0 = torch.tensor([[0.02, -0.02, 0.03]], device="cuda")
    bp, bq, bqc = bench_icp_inputs(torch)
    return {"mapper_1x360x16384_step0.05": (p, mask, q, qc, x0, 0.05),
            "bench_2048x360x360": (
                bp, torch.ones(bp.shape[:2], dtype=torch.bool,
                               device="cuda"), bq, bqc,
                torch.zeros(bp.shape[0], 3, device="cuda"), None)}


def check_icp_solve(torch):
    """One iteration of the ICP solve kernel against its plain version
    (``ops/icp.solve_step_reference``) on the same pose, source and K4
    indices, on every input set; gates: the pose within 1e-5 (m, rad),
    the source within 2e-5 m, chi within rtol 1e-5, and at the mapper's
    shape the pose and the source bitwise the plain version run
    unbatched, as the benchmark's reference runs it (the kernel sums in
    cuBLAS's order there).  Then device times of the kernel and its plain
    version, and the bound of its bytes and operations beside a one-element
    fill (the floor of a launch timed this way).  Returns the kernels-line
    numbers of the mapper's shape (the main path's) and bench's."""
    from slamrs_tpu_torch.ops import icp

    out = {}
    for label, (p, mask, q, qc, x0, thr) in icp_solve_cases(torch).items():
        b, n_p = p.shape[:2]
        p_t = icp.transform_points(p, x0)
        corr = icp.nearest_neighbors(p_t, q, qc)
        x, got_pt = x0.clone(), p_t.clone()
        chi = torch.empty(b, 1, device="cuda")
        before = icp.icp_solve.launches
        icp.icp_solve(p, mask, q, qc, corr, x, x, got_pt, chi, 0, thr)
        torch.cuda.synchronize()
        if icp.icp_solve.launches != before + 1:
            raise AssertionError("the icp_solve launch counter did not count")
        want_x, want_pt, want_chi = icp.solve_step_reference(
            p, mask, q, qc, x0, p_t, corr, thr)
        err = {"pose": float((x - want_x).abs().max()),
               "points": float((got_pt - want_pt).abs().max()),
               "chi_rel": float(((chi[:, 0] - want_chi).abs()
                                 / want_chi.abs().clamp_min(1e-30)).max())}
        bitwise = None
        if b == 1:
            one = icp.solve_step_reference(p[0], mask[0], q[0], qc[0], x0[0],
                                           p_t[0], corr[0], thr)
            bitwise = bool(torch.equal(x[0], one[0])
                           and torch.equal(got_pt[0], one[1]))
        ms = time_call(torch, lambda: icp.icp_solve(
            p, mask, q, qc, corr, x, x, got_pt, chi, 0, thr))
        plain_ms = time_call(torch, lambda: icp.solve_step_reference(
            p, mask, q, qc, x0, p_t, corr, thr))
        floor_ms = time_call(torch, lambda: torch.zeros(1, device="cuda"))
        t_bytes = b * n_p * ICP_SOLVE_LANE_BYTES / PEAK_BYTES_PER_S * 1e3
        t_ops = b * n_p * ICP_SOLVE_LANE_OPS / PEAK_F32_PER_S * 1e3
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
        emit({"phase": "kernel_vs_plain_icp_solve", "case": label,
              "p": list(p.shape), "q": list(q.shape),
              "q_count": qc.tolist()[:4], "step_threshold": thr,
              "max_abs_err_pose": err["pose"],
              "max_abs_err_points": err["points"],
              "max_rel_err_chi": err["chi_rel"],
              "bitwise_unbatched_plain": bitwise,
              "kernel_us": ms * 1e3, "plain_us": plain_ms * 1e3,
              "bound_us": bound * 1e3, "bound_by": by,
              "launch_floor_us": floor_ms * 1e3})
        if not (err["pose"] <= 1e-5 and err["points"] <= 2e-5
                and err["chi_rel"] <= 1e-5) or bitwise is False:
            raise AssertionError(f"icp_solve disagrees with its plain "
                                 f"version ({label}): {err}, bitwise "
                                 f"{bitwise}")
        out[label] = dict(max_abs_err=err["pose"], ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by,
                          launch_floor_ms=floor_ms)
    return out


# float32 operations of the simulator kernel: per tick of motion (cos
# and sin counted once each), per beam (its angle, cos, sin, the masks) and
# per beam and segment (the intersection's closed form, two divisions)
SIM_TICK_OPS = 14
SIM_BEAM_OPS = 8
SIM_BEAM_SEGMENT_OPS = 22
# the presets whose scenes the simulator kernel is checked on: the
# benchmark's three configurations (grid_slam_fused, grid_slam.yaml's
# fleet_config5, icp_test.yaml's icp_odometry)
SIM_PRESETS = ("grid_slam_fused.yaml", "grid_slam.yaml", "icp_test.yaml")
SIM_EDGE_POSES = (
    (0.0, -1.0, 0.0),    # on the room's bottom wall, beam 0 along it
    (0.3, 1.0, 0.0),     # on the top wall, beam 0 along it
    (1.0, 0.2, math.pi / 2),  # on the right wall, beam 0 ~along it
    (0.4, 0.4, math.pi / 4),  # beam 0 through the room's corner (1, 1)
    (-0.4, -0.4, -3 * math.pi / 4),  # beam 0 through (-1, -1)
    (-0.3, -0.7, 3 * math.pi / 4),  # beam 0 through the line's end
    (0.1, -0.25, -math.pi / 2),  # beam 0 at the small box's corners
    (0.0, 0.0, 0.0),     # corners past the 1 m range, walls at 1 m
    (0.05, 0.02, 0.3),   # hits past the range
    (3.0, 0.5, 0.0),     # outside the room: half the beams miss
    (-5.0, -5.0, 1.0),   # far outside
    (0.0, 10.0, -1.57))  # far outside, facing the room


def sim_frame_case(torch, worlds, k, seed):
    """The simulator kernel's inputs on the card: ``worlds`` poses (None:
    one world, for ``seed`` below ``len(SIM_EDGE_POSES)`` that edge pose
    standing still, so that it scans from there, else a random pose;
    otherwise random poses within 1.2 m of the room's centre with the edge
    poses in the first rows), accumulators as a frame leaves them, and
    ``k + 1`` random wheel speeds up to 0.3 m/s.  Returns ``(pose,
    accum_left, accum_right, speeds)``."""
    from slamrs_tpu_torch.core.types import Command

    g = torch.Generator().manual_seed(seed)
    edge = torch.tensor(SIM_EDGE_POSES, dtype=torch.float32)
    pose = torch.rand(worlds or 1, 3, generator=g) * 2.4 - 1.2
    pose[:, 2] *= math.pi / 1.2
    n = min(worlds or 0, len(edge))
    pose[:n] = edge[:n]
    accum = torch.rand(2, worlds or 1, generator=g) * 0.02 - 0.01
    speeds = torch.rand(2, k + 1, generator=g) * 0.6 - 0.3
    if worlds is None:
        pose, accum = pose[0], accum[:, 0]
        if seed < len(edge):
            pose, speeds = edge[seed], speeds * 0.0
    return (pose.cuda(), accum[0].cuda(), accum[1].cuda(),
            Command(*speeds.cuda()))


def sim_frame_same(torch, got, want) -> list:
    """The fields of two ``SimFrame`` that differ in any bit (floats
    compared as their int32 words, so -0.0 is not 0.0)."""
    def words(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    fields = [("pose", got.pose, want.pose),
              ("accum_left", got.accum_left, want.accum_left),
              ("accum_right", got.accum_right, want.accum_right)]
    if (got.scan is None) != (want.scan is None):
        return ["scan"]
    if got.scan is not None:
        fields += [(name, getattr(got.scan, name), getattr(want.scan, name))
                   for name in got.scan._fields]
    return [name for name, a, b in fields
            if a.shape != b.shape or not torch.equal(words(a), words(b))]


def sim_frame_pair(torch, fw, pose, al, ar, speeds, scan, params=None,
                   dt=None, num_beams=None):
    """The kernel and the plain version of ``sim_frame`` on the same
    inputs, the kernel's launch counted: ``(kernel, plain)``."""
    from slamrs_tpu_torch.models import simulator

    args = (pose, al, ar, speeds, params or fw.params,
            fw.dt if dt is None else dt, fw.scene if scan else None,
            num_beams or fw.num_beams)
    before = simulator.sim_frame.launches
    got = simulator.sim_frame(*args)
    if simulator.sim_frame.launches != before + 1:
        raise AssertionError("the sim_frame launch counter did not count")
    return got, simulator.sim_frame_reference(*args)


def sim_cos_sin_mismatches(torch) -> int:
    """The kernel's ``cosf``/``sinf`` against ``torch.cos``/``torch.sin``
    on the card over 2**20 angles (wide, near 0 and near multiples of
    pi / 2): a one-tick frame from ``(0, 0, theta)`` at unit travel and
    no turn gives ``(cos theta, sin theta, theta)``.  Returns the angles
    whose cos or sin differ."""
    from slamrs_tpu_torch.core.types import Command
    from slamrs_tpu_torch.models import simulator

    fw = preset_world(torch, "icp_test.yaml")
    g = torch.Generator(device="cuda").manual_seed(5)
    n = 1 << 20
    theta = torch.cat([
        torch.rand(n // 2, generator=g, device="cuda") * 200 - 100,
        torch.rand(n // 4, generator=g, device="cuda") * 8 - 4,
        (torch.arange(n // 4, device="cuda") - n // 8) * (math.pi / 2)
        / 1024])
    pose = torch.zeros(n, 3, device="cuda")
    pose[:, 2] = theta
    zeros = torch.zeros(n, device="cuda")
    one = torch.ones(1, device="cuda")
    got = simulator.sim_frame(pose, zeros, zeros, Command(one, one),
                              fw.params, 1.0)
    return int(((got.pose[:, 0] != torch.cos(theta))
                | (got.pose[:, 1] != torch.sin(theta))).sum())


def sim_deg2rad_mismatches(torch, beams=100_000) -> int:
    """The kernel's beam table against ``torch.deg2rad`` of ``arange`` on
    the card, bit for bit, over ``beams`` beams, and that scan against
    the plain version's.  Returns the beams and fields that differ."""
    from slamrs_tpu_torch.core.types import Command

    fw = preset_world(torch, "icp_test.yaml")
    zero = torch.zeros((), device="cuda")
    one = torch.ones(1, device="cuda")
    got, want = sim_frame_pair(torch, fw, torch.zeros(3, device="cuda"),
                               zero, zero, Command(one, one), True,
                               num_beams=beams)
    table = torch.deg2rad(torch.arange(beams, dtype=torch.float32,
                                       device="cuda"))
    return int((got.scan.angles.view(torch.int32)
                != table.view(torch.int32)).sum()) \
        + len(sim_frame_same(torch, got, want))


def sim_division_mismatches(torch) -> int:
    """The division by the Python-float wheel base: on the card ATen
    multiplies by the float32 reciprocal (over 2**20 values, three wheel
    bases), and the kernel's one-tick turn from theta 0 over 1,026 speed
    pairs equals the plain version's, every output.  Returns the values
    and pairs that differ."""
    import numpy as np

    from slamrs_tpu_torch.core.types import Command

    fw = preset_world(torch, "icp_test.yaml")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(-1, 1, 1 << 20).astype(np.float32)
                         ).cuda()
    zero = torch.zeros((), device="cuda")
    bad = 0
    for wb in (0.1, 0.25, 0.37):
        params = fw.params._replace(wheel_base=float(np.float32(wb)))
        inv = float(np.float32(1) / np.float32(wb))
        bad += int((x / params.wheel_base != x * inv).sum())
        for left, right in rng.uniform(-0.3, 0.3, (342, 2)):
            speeds = Command(torch.full((1,), float(left), device="cuda"),
                             torch.full((1,), float(right), device="cuda"))
            got, want = sim_frame_pair(
                torch, fw, torch.zeros(3, device="cuda"), zero, zero,
                speeds, False, params=params)
            bad += len(sim_frame_same(torch, got, want))
    return bad


def check_sim_frame(torch):
    """The simulator kernel against its plain version on the card
    (``models/simulator.sim_frame_reference``): every output bitwise on
    the scenes of :data:`SIM_PRESETS`, one world (each edge pose, still,
    and a random pose, moving) and 256 worlds (random poses and the edge
    poses, moving), ``k`` in {0, 1, 5} idle ticks before the last, the
    scan on and off; the roundings it repeats (cos and sin, ``deg2rad``,
    the division by the wheel base); then device times of the kernel and
    the plain chain at one world and at 256 for a 5 Hz frame (``k`` = 5)
    and a scan30hz frame (``k`` = 0), beside its bound and a one-element
    fill.  Returns the kernels-line numbers by case label."""
    from slamrs_tpu_torch.models import simulator

    cases = mismatched = 0
    for preset in SIM_PRESETS:
        fw = preset_world(torch, preset)
        for worlds in (None, 256):
            for k in (0, 1, 5):
                for scan in (False, True):
                    reps = len(SIM_EDGE_POSES) + 1 if worlds is None \
                        else 1
                    for seed in range(reps):
                        pose, al, ar, speeds = sim_frame_case(
                            torch, worlds, k, seed)
                        got, want = sim_frame_pair(torch, fw, pose, al, ar,
                                                   speeds, scan)
                        diff = sim_frame_same(torch, got, want)
                        cases += 1
                        if diff:
                            mismatched += 1
                            emit({"phase": "kernel_vs_plain_sim_frame",
                                  "preset": preset, "worlds": worlds,
                                  "k": k, "scan": scan, "seed": seed,
                                  "differs": diff})
    torch.cuda.synchronize()
    ops = {"cos_sin": sim_cos_sin_mismatches(torch),
           "deg2rad": sim_deg2rad_mismatches(torch),
           "division": sim_division_mismatches(torch)}
    times = {}
    fw = preset_world(torch, "grid_slam_fused.yaml")
    for worlds in (None, 256):
        for k in (5, 0):
            pose, al, ar, speeds = sim_frame_case(torch, worlds, k, 1)
            args = (pose, al, ar, speeds, fw.params, fw.dt, fw.scene,
                    fw.num_beams)
            ms = time_call(torch, lambda: simulator.sim_frame(*args))
            plain_ms = time_call(torch, lambda: simulator.sim_frame_reference(
                *args))
            floor_ms = time_call(torch, lambda: torch.zeros(1, device="cuda"))
            w = worlds or 1
            s_count = fw.scene.segments.shape[0]
            nbytes = w * (12 + 8 + 12 + 8 + fw.num_beams * 10) \
                + 8 * (k + 1) + 17 * s_count + 4 * fw.num_beams
            nops = w * ((k + 1) * SIM_TICK_OPS + fw.num_beams * (
                SIM_BEAM_OPS + s_count * SIM_BEAM_SEGMENT_OPS))
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = nops / PEAK_F32_PER_S * 1e3
            bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                         else (t_ops, "operations"))
            label = f"{w}x_k{k}"
            times[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                bound_by=by, launch_floor_ms=floor_ms)
            emit({"phase": "kernel_time_sim_frame", "case": label,
                  "worlds": w, "idle_ticks": k, "kernel_us": ms * 1e3,
                  "plain_us": plain_ms * 1e3, "bound_us": bound * 1e3,
                  "bound_by": by, "launch_floor_us": floor_ms * 1e3})
    emit({"phase": "kernel_vs_plain_sim_frame", "cases": cases,
          "mismatched_cases": mismatched, "ops_mismatches": ops,
          "bitwise_equal": mismatched == 0 and not any(ops.values())})
    if mismatched or any(ops.values()):
        raise AssertionError(f"sim_frame disagrees with its plain version: "
                             f"{mismatched} of {cases} cases, ops {ops}")
    return times


def preset_world(torch, name, device="cuda"):
    from slamrs_tpu_torch.graph.compile import compile_world
    from slamrs_tpu_torch.graph.config import load_config

    root = Path(__file__).resolve().parent
    return compile_world(load_config(root / "configs" / name), device=device)


def pose_rmse(torch, est, truth):
    err = est[:, :2].float() - truth[:, :2].float()
    return float(torch.sqrt((err ** 2).mean()))


def check_icp_world(torch):
    """The ICP preset for 900 ticks on the card with the counts set to 0
    just before and read just after, then its first 300 ticks on the
    CPU.  Returns (counts, outs, state)."""
    fw = preset_world(torch, "icp_test.yaml")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = fw.rollout_cadence(fw.init(), 900, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    frames = int(outs.fired.shape[0])
    rmse = pose_rmse(torch, outs.icp_pose, outs.pose)
    finite = all(bool(torch.isfinite(t).all()) for t in (
        outs.pose, outs.icp_pose, state.icp.points, state.icp.pose))
    count = int(state.icp.count)
    emit({"phase": "rollout_icp_900", "ticks": 900, "frames": frames,
          "launch_counts": counts, "map_count": count,
          "map_capacity": fw.icp_config.capacity,
          "icp_pose_rmse_xy_m": rmse, "finite": finite, "seconds": seconds})
    iters = fw.icp_config.iterations
    if counts["nn_argmin"] != iters * frames:
        raise AssertionError(f"{counts['nn_argmin']} nn_argmin launches, "
                             f"expected {iters} x {frames} frames")
    if counts["icp_solve"] != (iters + 1) * frames:
        raise AssertionError(f"{counts['icp_solve']} icp_solve launches, "
                             f"expected {iters + 1} x {frames} frames")
    if count != fw.icp_config.capacity or not finite:
        raise AssertionError(f"ICP map holds {count} points (finite: "
                             f"{finite})")
    if not rmse <= ICP_RMSE_GATE_M:
        raise AssertionError(f"ICP pose RMSE {rmse} m > {ICP_RMSE_GATE_M} m")

    cpu = preset_world(torch, "icp_test.yaml", device="cpu")
    t0 = time.perf_counter()
    _, cpu_outs = cpu.rollout_cadence(cpu.init(), 300, seed=0)
    cpu_s = time.perf_counter() - t0
    n = int(cpu_outs.fired.shape[0])
    gap = (outs.icp_pose[:n].cpu() - cpu_outs.icp_pose).abs().amax(dim=1)
    over = torch.nonzero(gap > ICP_CPU_GATE_M)
    first = int(over[0]) if over.numel() else None
    emit({"phase": "icp_card_vs_cpu_300", "frames": n,
          "max_pose_diff_m": float(gap.max()),
          "first_frame_over_gate": first,
          "per_frame_max_diff_m": [float(x) for x in gap[::8]],
          "cpu_seconds": cpu_s,
          "cpu_icp_pose_rmse_xy_m": pose_rmse(torch, cpu_outs.icp_pose,
                                              cpu_outs.pose)})
    if first is not None:
        raise AssertionError(f"card and CPU ICP poses differ by "
                             f"{float(gap[first])} m at frame {first}")
    return counts, outs, state


def check_ekf_world(torch):
    """The landmark preset for 300 ticks on the card; returns the world
    and its final state."""
    fw = preset_world(torch, "landmarks.yaml")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = fw.rollout_cadence(fw.init(), 300, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rmse = pose_rmse(torch, outs.ekf_pose, outs.pose)
    finite = all(bool(torch.isfinite(t).all()) for t in (
        outs.pose, outs.ekf_pose, state.ekf.mean, state.ekf.cov))
    emit({"phase": "rollout_ekf_300", "ticks": 300,
          "frames": int(outs.fired.shape[0]), "launch_counts": read_counts(),
          "ekf_pose_rmse_xy_m": rmse, "finite": finite,
          "landmarks_seen": int(state.ekf.seen.sum()), "seconds": seconds})
    if not finite or not rmse <= EKF_RMSE_GATE_M:
        raise AssertionError(f"EKF pose RMSE {rmse} m > {EKF_RMSE_GATE_M} m "
                             f"(finite: {finite})")
    return fw, state


def check_icp_ekf_no_host_sync(torch, icp_state, ekf_world, ekf_state):
    """One ICP mapper update at the full map and one EKF update never
    wait for the card."""
    from slamrs_tpu_torch.core.types import OdometryReading
    from slamrs_tpu_torch.models import ekf, icp_mapper
    from slamrs_tpu_torch.models.simulator import landmark_scan, lidar_scan

    icp_world = preset_world(torch, "icp_test.yaml")
    pose = torch.tensor([0.1, -0.2, 0.3], device="cuda")
    scan = lidar_scan(pose, icp_world.scene, 1.0, 360)
    lm = landmark_scan(pose, ekf_world.scene, ekf_world.params,
                       generator=torch.Generator(device="cuda").manual_seed(4))
    odo = OdometryReading(torch.full((), 0.01, device="cuda"),
                          torch.full((), 0.012, device="cuda"),
                          ekf_world.params.wheel_base)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, out = icp_mapper.update(icp_state, scan, icp_world.icp_config)
        est, eout = ekf.update(ekf_state, lm, odo, ekf_world.ekf_config)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit({"phase": "no_host_sync_icp_ekf", "ok": True,
          "map_count": int(st.count),
          "poses_finite": bool(torch.isfinite(out.pose).all()
                               and torch.isfinite(eout.pose).all())})


def xla_form_nn(torch, p, q, q_count):
    """The JAX package's XLA form in torch, the library yardstick for K4:
    ``q2 - 2 p q^T`` by ``baddbmm``, invalid lanes masked, ``argmin``.
    Timed here only; the port never calls it."""
    q2 = (q * q).sum(-1)
    d2 = torch.baddbmm(q2[:, None, :], p, q.transpose(1, 2), alpha=-2.0)
    valid = torch.arange(q.shape[1], device=q.device) < q_count[:, None]
    d2 = torch.where(valid[:, None, :], d2, 1e30)
    return torch.argmin(d2, dim=-1).to(torch.int32)


def time_nn(torch, launched):
    """Device times of K4, its plain version and the XLA form at bench.py's
    batch and the mapper's shape, with K4's bound and ``launched`` (the
    CUDA launches of one call, from :func:`check_nn_launches`); returns
    the kernels-line numbers of the mapper shape (the main path's) and
    bench's."""
    from slamrs_tpu_torch.ops import icp

    cases = nn_cases(torch)
    out = {}
    for label in ("bench_2048x360x360", "mapper_1x360x16384_qc10000"):
        p, q, qc = cases[label]
        b, n_p, nq = p.shape[0], p.shape[1], q.shape[1]
        names = launched[label]
        ms = time_call(torch, lambda: icp.launch_kernel(p, q, qc))
        plain_ms = time_call(torch, lambda: icp.nearest_neighbors_reference(
            p, q, qc))
        lib_ms = time_call(torch, lambda: xla_form_nn(torch, p, q, qc))
        lib_diff = int((xla_form_nn(torch, p, q, qc)
                        != icp.launch_kernel(p, q, qc)).sum())
        # what these inputs need: the q lanes below q_count; the figure
        # over every lane beside it
        filled = int(torch.clamp(qc, 0, nq).sum())
        bound, by = nn_bound(b * n_p, filled, b)
        bound_all, _ = nn_bound(b * n_p, b * nq, b)
        pairs = n_p * filled
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=by)
        emit({"phase": "kernel_time_nn", "case": label,
              "plan": list(icp.nn_plan(b, n_p, nq)),
              "cuda_launches_per_call": len(names), "launched": names,
              "pairs": pairs, "pairs_all_lanes": b * n_p * nq,
              "kernel_us": ms * 1e3,
              "plain_us": plain_ms * 1e3, "xla_form_us": lib_ms * 1e3,
              "xla_form_index_mismatches": lib_diff,
              "bound_us": bound * 1e3, "bound_by": by,
              "bound_all_lanes_us": bound_all * 1e3,
              "g_pairs_per_s": pairs / ms / 1e6,
              "issue_slots_per_pair": ms * 1e-3 * H100_ISSUE_SLOTS_PER_S
              / pairs})
    return out


def check_nn_launches(torch):
    """The CUDA kernels and memsets of one K4 call at bench.py's batch and
    at the mapper's shape, under ``torch.profiler``; gate: one nn_argmin
    kernel and nothing else.  Runs before any long profiled run in the
    process (after those, a short profile here recorded no device
    events)."""
    from slamrs_tpu_torch.ops import icp

    cases = nn_cases(torch)
    launched = {}
    for label in ("bench_2048x360x360", "mapper_1x360x16384_qc10000"):
        p, q, qc = cases[label]
        icp.launch_kernel(p, q, qc)  # the arrival counters exist now
        torch.cuda.synchronize()
        names = cuda_launches(torch, lambda: icp.launch_kernel(p, q, qc))
        launched[label] = names
        emit({"phase": "nn_launches_per_call", "case": label,
              "cuda_launches": len(names), "launched": names})
        if len(names) != 1 or "nn_argmin" not in names[0]:
            raise AssertionError(f"K4 call launched {names}, expected one "
                                 f"nn_argmin kernel and nothing else")
    return launched


def nn_bound(p_lanes, q_lanes, problems):
    """(ms, bound_by) of K4 over ``problems`` problems of equal p width,
    ``p_lanes`` source and ``q_lanes`` reference points in all: each
    point and count read once, each index written once; 6 float32
    operations per (p, q) pair of one problem."""
    nbytes = (p_lanes * 2 + q_lanes * 2 + problems + p_lanes) * 4
    pairs = p_lanes * q_lanes / problems
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = pairs * NN_PAIR_OPS / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_launches(torch, fn):
    """Names of the CUDA kernels and memsets that one ``fn()`` puts on the
    card, from ``torch.profiler`` (one entry per launch)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type.name == "CUDA" for _ in range(e.count)]


def time_icp_batch(torch, reps=5):
    """Batched ICP at bench.py's shape: 2,048 problems x 10 iterations,
    K4 and the solve kernel on every iteration, the solve kernel once
    before; host clock around synchronized solves."""
    from slamrs_tpu_torch.ops import icp

    p, q, qc = bench_icp_inputs(torch)
    mask = torch.ones(p.shape[:2], dtype=torch.bool, device="cuda")
    x0 = torch.zeros(p.shape[0], 3, device="cuda")
    icp.icp_point_to_normal(p, mask, q, qc, x0, iterations=10)  # warm
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        before = icp.nearest_neighbors_fused.launches
        solves = icp.icp_solve.launches
        t0 = time.perf_counter()
        res = icp.icp_point_to_normal(p, mask, q, qc, x0, iterations=10)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if icp.nearest_neighbors_fused.launches != before + 10:
            raise AssertionError("batched ICP did not launch K4 per iteration")
        if icp.icp_solve.launches != solves + 11:
            raise AssertionError("batched ICP did not launch the solve kernel "
                                 "per iteration and once before")
    sec = statistics.median(times)
    emit({"phase": "icp_batch_2048x10", "problems": p.shape[0],
          "iterations": 10, "median_s": sec, "all_s": times,
          "icp_iterations_per_s": p.shape[0] * 10 / sec,
          "finite": bool(torch.isfinite(res.transformation).all())})


def time_icp_ekf_rollouts(torch):
    """Warm 900-tick ICP and 300-tick EKF runs, then a profiled 300-tick
    ICP run."""
    for name, ticks, est in (("icp_test.yaml", 900, "icp_pose"),
                             ("landmarks.yaml", 300, "ekf_pose")):
        fw = preset_world(torch, name)
        fw.rollout_cadence(fw.init(), 30, seed=2)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, outs = fw.rollout_cadence(fw.init(), ticks, seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        emit({"phase": f"rollout_time_{name.split('.')[0]}_{ticks}",
              "ticks": ticks, "frames": int(outs.fired.shape[0]),
              "seconds": seconds, "ticks_per_s": ticks / seconds,
              f"{est}_rmse_xy_m": pose_rmse(torch, getattr(outs, est),
                                            outs.pose),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    profile_rollout(torch, preset_world(torch, "icp_test.yaml"), "icp_300",
                    kernel="nn_argmin")


# --- grid SLAM's dda and dense integrators (plain PyTorch, no kernel) ---

GRID_SLAM_RMSE_GATE_M = 0.15
GRID_SLAM_CPU_GATE_M = 0.04  # 2 cells of configs/grid_slam.yaml
MAP_CELL_TOL, MAP_AGREE = 5e-3, 0.999  # tests/test_parity.py's map gate
DEVIATION_CELLS, DEVIATION_AGREE = 2, 0.90  # tests/test_path_deviation.py
# tests/test_path_deviation.py's draws: its key chain (jax.random.key(7),
# one split a step) through slamrs_tpu's derive_noise for 6 particles,
# per step eps_c[6] + eps_t[6] + u01; tests/test_torch_gridslam.py holds
# these values to the JAX package's
PATH_DEVIATION_DRAWS = [
    [-0.014316261745989323, -1.9772720336914062, -0.464983195066452,
     -1.818358302116394, 1.3057658672332764, 0.31368598341941833,
     -1.8414205312728882, 1.3842440843582153, 0.14463147521018982,
     -1.0966203212738037, -0.31351569294929504, -1.719457745552063,
     0.2391601800918579],
    [1.3121635913848877, 0.3231795132160187, 1.3230540752410889,
     -0.528336226940155, -2.562178134918213, -1.2474901676177979,
     0.7203118801116943, 0.337359756231308, 0.2876996397972107,
     1.123923659324646, 0.2675434648990631, -2.111067771911621,
     0.30930447578430176],
    [0.7078719139099121, 0.23987318575382233, -0.4109421372413635,
     -0.7684392929077148, -1.1011642217636108, -0.7782418131828308,
     -0.8828319907188416, -1.3621946573257446, -1.0295859575271606,
     -0.6978057026863098, -0.19328011572360992, 0.6058013439178467,
     0.614766001701355],
    [0.07835733145475388, 0.44666239619255066, 1.595667839050293,
     0.07967682182788849, -1.1302273273468018, -0.35618165135383606,
     -0.9628964066505432, -0.25974565744400024, -0.8822312355041504,
     0.25651803612709045, 0.42029353976249695, -1.8359770774841309,
     0.21386468410491943],
    [0.8658902049064636, 0.48835399746894836, 1.4777336120605469,
     0.11346644908189774, 1.8833987712860107, -1.2736238241195679,
     1.0560027360916138, -0.9665396809577942, 0.242921382188797,
     -0.18299680948257446, -0.08687581866979599, 0.7200927138328552,
     0.8043084144592285],
    [-1.516849398612976, -0.005526506807655096, -1.0687272548675537,
     -2.2421302795410156, -1.391342282295227, 0.3184681236743927,
     -0.9615846872329712, -0.9271396994590759, 1.3962315320968628,
     -0.60442715883255, -0.7884882688522339, -0.7822952270507812,
     0.7463116645812988]]


def grid_op_inputs(torch, spec, p=1024, seed=81):
    """Random inputs for the grid functions, made on the CPU: log-odds
    maps (~30 % nonzero, the rest exactly 0), poses across the map (six
    on its edges), and a 360-beam scan out to 1.2 m (some past the range),
    ~80 % valid, the last ten beams absent."""
    g = torch.Generator().manual_seed(seed)
    grids = torch.randn(p, spec.rows, spec.cols, generator=g) * 2.0
    grids[torch.rand(grids.shape, generator=g) > 0.3] = 0.0
    lo = torch.tensor([spec.position_x + 0.2, spec.position_y + 0.2,
                       -math.pi])
    ext = torch.tensor([spec.width - 0.4, spec.height - 0.4, 2 * math.pi])
    poses = lo + ext * torch.rand(p, 3, generator=g)
    edge_poses(poses, spec)
    angles = 0.1 + torch.deg2rad(torch.arange(360, dtype=torch.float32))
    dist = 0.05 + 1.15 * torch.rand(360, generator=g)
    valid = torch.rand(360, generator=g) < 0.8
    present = torch.ones(360, dtype=torch.bool)
    present[350:] = False
    return grids, poses, (angles, dist, valid, present)


def map_agreement(torch, a, b):
    """(share of cells within MAP_CELL_TOL, share of b's touched cells
    whose sign a shares, max |a - b|) of two f32 map sets."""
    diff = (a - b).abs()
    touched = b.abs() > 1e-6
    sign = (torch.sign(a[touched]) == torch.sign(b[touched])).float()
    return (float((diff <= MAP_CELL_TOL).float().mean()),
            float(sign.mean()) if sign.numel() else 1.0, float(diff.max()))


def check_grid_ops(torch):
    """(a) The grid functions on the card against the same on the CPU, on
    the same 1,024-particle inputs at 0.05 m: ``traverse_ray`` on
    identical grid coordinates bitwise; ``grid_integrate`` and
    ``grid_integrate_dense`` at the map gate (>= 99.9 % of cells within
    5e-3; the card's cos, sin and atan2 are a few ulps from the CPU's);
    ``grid_log_likelihood`` within rtol 1e-5 / atol 1e-4 on >= 99.9 % of
    the particles; ``grid_integrate`` twice on the card bitwise equal.
    Returns the device times (ms) of the three functions."""
    from slamrs_tpu_torch.ops import grid as G

    spec = _spec((-2.0, -2.0, 4.0, 4.0, 0.05))
    grids, poses, scan = grid_op_inputs(torch, spec)
    steps = spec.max_ray_steps(1.0)
    window = G.dense_window_for(spec, 1.0)

    def cuda(t):
        return t.to("cuda")

    g_c, p_c, scan_c = cuda(grids), cuda(poses), tuple(cuda(t) for t in scan)
    start = spec.world_to_grid(poses[:, 0:2])
    ends = spec.world_to_grid(G.scan_endpoints(poses, scan[0], scan[1]))
    ray = (start[:, 0:1], start[:, 1:2], ends[..., 0], ends[..., 1])
    on_cpu = G.traverse_ray(*ray, spec.cols, spec.rows, steps)
    on_card = G.traverse_ray(*(cuda(t) for t in ray), spec.cols, spec.rows,
                             steps)
    ray_equal = all(bool(torch.equal(a, b.cpu()))
                    for a, b in zip(on_cpu, on_card))
    lanes = int(on_cpu[3].sum())
    del on_card

    out = {}
    for name, fn, extra in (("grid_integrate", G.grid_integrate, steps),
                            ("grid_integrate_dense", G.grid_integrate_dense,
                             window)):
        want = fn(grids, spec, poses, *scan, extra)
        got = fn(g_c, spec, p_c, *scan_c, extra)
        again = fn(g_c, spec, p_c, *scan_c, extra)
        torch.cuda.synchronize()
        agree, sign, err = map_agreement(torch, got.cpu(), want)
        repeat = bool(torch.equal(got, again))
        out[name] = time_call(torch, lambda: fn(g_c, spec, p_c, *scan_c,
                                                  extra))
        emit({"phase": f"grid_ops_card_vs_cpu_{name}",
              "shape": list(got.shape), "cells_within_5e-3": agree,
              "touched_sign_agreement": sign, "max_abs_err": err,
              "card_repeat_bitwise_equal": repeat, "ms": out[name]})
        if not (agree >= MAP_AGREE and sign >= MAP_AGREE):
            raise AssertionError(f"{name} on the card disagrees with the CPU "
                                 f"({agree}, {sign})")
        if name == "grid_integrate" and not repeat:
            raise AssertionError("grid_integrate on the card is not bitwise "
                                 "reproducible")
        del got, again
    want = G.grid_log_likelihood(grids, spec, poses, *scan)
    got = G.grid_log_likelihood(g_c, spec, p_c, *scan_c).cpu()
    close = (got - want).abs() <= LIK_ATOL + LIK_RTOL * want.abs()
    lik_share = float(close.float().mean())
    out["grid_log_likelihood"] = time_call(
        torch, lambda: G.grid_log_likelihood(g_c, spec, p_c, *scan_c))
    emit({"phase": "grid_ops_card_vs_cpu", "particles": 1024,
          "max_steps": steps, "dense_window": window,
          "traverse_ray_bitwise_equal": ray_equal, "ray_lanes": lanes,
          "lik_share_within_gate": lik_share,
          "lik_max_abs_err": float((got - want).abs().max()),
          "lik_ms": out["grid_log_likelihood"]})
    if not ray_equal:
        raise AssertionError("traverse_ray on the card differs from the CPU")
    if not lik_share >= MAP_AGREE:
        raise AssertionError(f"grid_log_likelihood within the gate on only "
                             f"{lik_share} of the particles")
    return out


def recording_ancestors(gs):
    """Wrap ``gs._weigh_and_select`` so each update's ancestors are kept;
    returns the list and a function that restores the original."""
    orig = gs._weigh_and_select
    kept = []

    def wrapped(*args):
        result = orig(*args)
        kept.append(result[1])
        return result

    gs._weigh_and_select = wrapped

    def restore():
        gs._weigh_and_select = orig

    return kept, restore


def injected_grid_noise(fw, n_steps, seed, worlds=()):
    """Per-frame grid-SLAM draws from numpy for ``n_steps`` ticks of a
    fresh world (or fleet of ``worlds``): (eps_c [F, *worlds, P],
    eps_t [F, *worlds, P], u01 [F, *worlds, 1])."""
    import numpy as np

    period = np.float32(fw.params.update_period)
    timer, frames = np.float32(0.0), 0
    for _ in range(n_steps):
        timer = np.float32(timer + np.float32(fw.dt))
        if timer > period:
            frames += 1
            timer = np.float32(timer - period)
    rng = np.random.default_rng(seed)
    p = fw.grid_config.n_particles
    return (rng.standard_normal((frames, *worlds, p)).astype(np.float32),
            rng.standard_normal((frames, *worlds, p)).astype(np.float32),
            rng.random((frames, *worlds, 1)).astype(np.float32))


def check_grid_slam_yaml(torch):
    """(b) ``compile_world(configs/grid_slam.yaml)`` (dda, 10 particles at
    0.02 m) for 300 ticks on the card with injected draws, then the same
    ticks and draws on the CPU.  Returns the card world."""
    from slamrs_tpu_torch.models import gridslam as gs

    fw = preset_world(torch, "grid_slam.yaml")
    cpu = preset_world(torch, "grid_slam.yaml", device="cpu")
    if fw.grid_config.integrate != "dda":
        raise AssertionError("configs/grid_slam.yaml is not the dda path")
    noise = injected_grid_noise(fw, 300, 6)
    kept, restore = recording_ancestors(gs)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, outs = fw.rollout_cadence(fw.init(), 300, seed=0, noise=noise)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        card_anc = [a.cpu() for a in kept]
        kept.clear()
        _, cpu_outs = cpu.rollout_cadence(cpu.init(), 300, seed=0,
                                          noise=noise)
        cpu_anc = list(kept)
    finally:
        restore()
    frames = int(outs.fired.shape[0])
    rmse = pose_rmse(torch, outs.grid_pose, outs.pose)
    wsum = float(state.grid.weights.sum())
    finite = all(bool(torch.isfinite(t).all()) for t in (
        outs.pose, outs.grid_pose, outs.n_eff, state.grid.weights,
        state.grid.poses, state.grid.grids))
    gap = pose_rmse(torch, outs.grid_pose.cpu(), cpu_outs.grid_pose)
    differ = [f for f, (a, b) in enumerate(zip(card_anc, cpu_anc))
              if not torch.equal(a, b)]
    emit({"phase": "rollout_grid_slam_yaml_300", "ticks": 300,
          "frames": frames, "grids": list(state.grid.grids.shape),
          "launch_counts": counts, "grid_pose_rmse_xy_m": rmse,
          "cpu_grid_pose_rmse_xy_m": pose_rmse(torch, cpu_outs.grid_pose,
                                               cpu_outs.pose),
          "card_vs_cpu_best_pose_rmse_m": gap,
          "frames_where_ancestors_differ": differ, "weights_sum": wsum,
          "finite": finite, "seconds": seconds})
    if any(slam_counts(counts).values()) \
            or counts["sim_frame"] != sim_launches(fw, 300):
        raise AssertionError(f"the dda path launched a kernel: {counts}")
    if not finite or abs(wsum - 1.0) > 1e-5:
        raise AssertionError("non-finite outputs or weights not normalized")
    if not rmse <= GRID_SLAM_RMSE_GATE_M:
        raise AssertionError(f"grid_slam.yaml RMSE {rmse} m > "
                             f"{GRID_SLAM_RMSE_GATE_M} m")
    if not gap <= GRID_SLAM_CPU_GATE_M:
        raise AssertionError(f"card and CPU best poses differ by {gap} m "
                             f"RMSE")
    return fw


NO_KERNELS = {"fused_update": 0, "fused_update_tiled": 0, "cow_copy": 0,
              "nn_argmin": 0, "icp_solve": 0}


def check_path_deviation(torch):
    """(d) ``tests/test_path_deviation.py`` on the card: the same 6 updates
    (its scene, odometry and draws) through dda, dense and fused (K1);
    best-pose RMSE against dda <= 2 cells, occupancy classification
    agreement >= 90 % of the cells either path touched."""
    from slamrs_tpu_torch.core import motion
    from slamrs_tpu_torch.core.types import OdometryReading
    from slamrs_tpu_torch.models import gridslam as gs
    from slamrs_tpu_torch.models.simulator import Scene, lidar_scan

    p, res = 6, 0.05
    scene = Scene.build(rects=[(-1.0, -1.0, 2.0, 2.0),
                               (-0.1, -0.4, 0.5, 0.1)],
                        lines=[(-0.6, -0.4, 0.2, 0.4)], device="cuda")
    draws = torch.tensor(PATH_DEVIATION_DRAWS, device="cuda")

    def rollout(integrate):
        cfg = gs.GridSlamConfig(position_x=-2.0, position_y=-2.0, width=4.0,
                                height=4.0, resolution=res, n_particles=p,
                                max_scan_range=1.0, integrate=integrate,
                                resample_neff_frac=1.0)
        state = gs.GridSlamState.init(cfg, "cuda")
        pose = torch.zeros(3, device="cuda")
        sl = torch.full((), 0.004, device="cuda")
        sr = torch.full((), 0.0065, device="cuda")
        odo = OdometryReading(sl, sr, torch.full((), 0.1, device="cuda"))
        best = []
        for row in draws:
            pose = motion.integrate_exact(pose, sl, sr, 0.1)
            scan = lidar_scan(pose, scene, 1.0, 360)
            noise = gs.UpdateNoise(row[:p], row[p:2 * p], row[2 * p:])
            state, out = gs.update(state, scan, odo, cfg, noise=noise)
            best.append(out.pose)
        return torch.stack(best), gs.estimated_probability_grid(state, cfg)

    def cls(g):
        return torch.where(g > 0.6, 1, torch.where(g < 0.4, -1, 0))

    reset_counts()
    poses_dda, grid_dda = rollout("dda")
    failed = []
    for name in ("dense", "fused"):
        poses, grid = rollout(name)
        rmse = pose_rmse(torch, poses, poses_dda)
        a, b = cls(grid_dda), cls(grid)
        touched = (a != 0) | (b != 0)
        agree = float((a[touched] == b[touched]).float().mean())
        emit({"phase": f"path_deviation_{name}_vs_dda", "particles": p,
              "updates": len(PATH_DEVIATION_DRAWS), "pose_rmse_m": rmse,
              "cell_agreement": agree, "touched_cells": int(touched.sum()),
              "launch_counts": read_counts()})
        if not (rmse <= DEVIATION_CELLS * res and agree >= DEVIATION_AGREE):
            failed.append(name)
    if read_counts()["fused_update"] != len(PATH_DEVIATION_DRAWS):
        raise AssertionError("the fused path did not launch K1 per update")
    if failed:
        raise AssertionError(f"{failed} deviate from dda beyond the gates")


def check_nonfused_no_host_sync(torch):
    """(e) One dda and one dense update at the headline shape (1,024
    particles, 0.05 m) never wait for the card."""
    from slamrs_tpu_torch.core.types import OdometryReading
    from slamrs_tpu_torch.models import gridslam as gs
    from slamrs_tpu_torch.models.simulator import lidar_scan

    for integrate in ("dda", "dense"):
        fw = headline_world(torch, 0.05, integrate, "float32")
        st = fw.init().grid
        pose = torch.tensor([0.1, -0.2, 0.3], device="cuda")
        scan = lidar_scan(pose, fw.scene, 1.0, 360)
        odo = OdometryReading(torch.full((), 0.01, device="cuda"),
                              torch.full((), 0.012, device="cuda"),
                              fw.params.wheel_base)
        gen = torch.Generator(device="cuda").manual_seed(3)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, out = gs.update(st, scan, odo, fw.grid_config, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        emit({"phase": f"no_host_sync_{integrate}", "ok": True,
              "pose_finite": bool(torch.isfinite(out.pose).all())})


def time_nonfused_rollouts(torch, grid_slam_world):
    """(f) Warm 300-tick dda and dense runs at the headline shape and a
    warm 300-tick ``configs/grid_slam.yaml`` run: ticks/s and peak
    memory; then a profiled 300-tick dda run at the headline shape."""
    runs = (("dda_0.05m", headline_world(torch, 0.05, "dda", "float32")),
            ("dense_0.05m", headline_world(torch, 0.05, "dense", "float32")),
            ("grid_slam_yaml", grid_slam_world))
    for label, fw in runs:
        fw.rollout_cadence(fw.init(), 30, seed=2)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, outs = fw.rollout_cadence(fw.init(), 300, seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        emit({"phase": f"rollout_time_{label}_300", "ticks": 300,
              "frames": int(outs.fired.shape[0]), "seconds": seconds,
              "ticks_per_s": 300 / seconds,
              "grid_pose_rmse_xy_m": pose_rmse(torch, outs.grid_pose,
                                               outs.pose),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    profile_rollout(torch, runs[0][1], "dda_0.05m_300")


# --- fleets: batched worlds on one card (BASELINE config 5) ---

FLEET_WORLDS, FLEET_PARTICLES = 256, 10  # bench.py:151-167
FLEET_CPU_WORLDS, FLEET_CPU_TICKS = 4, 60


def fleet_world(torch, device="cuda", **grid_kw):
    """``make_fused`` with bench.py's ``fleet`` values (``bench.py:151-167``):
    10 particles on 4 x 4 m maps at 0.02 m (f32 ``[W, 10, 200, 256]``),
    ``integrate="fused"``, N_eff gate 0.5, a scan every 0.2 s, the default
    scene and command."""
    from slamrs_tpu_torch.graph.compile import make_fused
    from slamrs_tpu_torch.models.gridslam import GridSlamConfig
    from slamrs_tpu_torch.models.simulator import SimParams

    kw = dict(position_x=-2.0, position_y=-2.0, width=4.0, height=4.0,
              resolution=0.02, n_particles=FLEET_PARTICLES,
              max_scan_range=1.0, resample_neff_frac=0.5, integrate="fused")
    kw.update(grid_kw)
    return make_fused(params=SimParams.make(update_period=0.2),
                      grid_config=GridSlamConfig(**kw), device=device)


def fleet_kernel_case(torch, spec, worlds, p, seed, static, far=True):
    """K1's inputs for a fleet, made on the card: one 360-beam scan per
    world from the simulator at a random per-world pose (six worlds on
    the grid's edges), with ``far`` a third of the beams out to 5 m in a
    quarter of the worlds; a first-beam angle per world; each world's
    particles within 0.05 m of its pose; maps of random log-odds (~30 %
    exact zeros); block-diagonal lineage."""
    from slamrs_tpu_torch.models.simulator import Scene, lidar_scan

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    scene = Scene.build(rects=YAML_RECTS, lines=YAML_LINES, device=dev)
    lo = torch.tensor([-1.3, -1.3, -math.pi], device=dev)
    hi = torch.tensor([1.3, 1.3, math.pi], device=dev)
    centers = lo + (hi - lo) * torch.rand(worlds, 3, generator=g, device=dev)
    if worlds >= 6:
        edge_poses(centers, spec)
    scan = lidar_scan(centers, scene, 1.0, 360)
    dist = scan.distances.clone()
    if far:
        far_beams(torch, dist[: max(worlds // 4, 1)].view(-1), g)
    poses = (centers[:, None, :] + 0.05 * torch.randn(
        worlds, p, 3, generator=g, device=dev)).reshape(-1, 3).contiguous()
    rows, cols = spec.rows, (spec.cols + 127) // 128 * 128
    grids = torch.randn(worlds * p, rows, cols, generator=g, device=dev) * 2.0
    grids[torch.rand(grids.shape, generator=g, device=dev) < 0.3] = 0.0
    anc = (torch.randint(0, p, (worlds, p), generator=g, device=dev)
           + p * torch.arange(worlds, device=dev)[:, None]).reshape(-1)
    a0 = 0.1 * torch.rand(worlds, generator=g, device=dev)
    dphi = math.radians(1.0) if static else torch.full(
        (worlds,), math.radians(1.0), device=dev)
    return (grids, poses, a0, dist, scan.valid, scan.present, spec, 360,
            1.0), dict(ancestors=anc.to(torch.int32), dphi=dphi)


def check_k1_fleet(torch, spec):
    """K1 with the world axis against its plain version at the fleet's
    ``[2560, 200, 256]`` f32, in place and in lineage mode (block-diagonal
    ancestors), static and traced spacing: maps equal by value,
    likelihood rtol 1e-5 / atol 1e-4, one launch for the fleet.  Then a
    one-world call against the single-world call, bitwise.  Returns the
    worst absolute error."""
    from slamrs_tpu_torch.ops import fused

    worst = 0.0
    w, p = FLEET_WORLDS, FLEET_PARTICLES
    for mode in ("in_place", "lineage"):
        for static in (True, False):
            args, kw = fleet_kernel_case(torch, spec, w, p, 91, static)
            if mode == "in_place":
                kw = dict(dphi=kw["dphi"], in_place=True)
                g_p, l_p = fused.fused_update_reference(args[0].clone(),
                                                        *args[1:], **kw)
            else:
                g_p, l_p = fused.fused_update_reference(*args, **kw)
            before = fused.fused_update.launches
            g_k, l_k = fused.fused_update(*args, **kw)
            torch.cuda.synchronize()
            launched = fused.fused_update.launches - before
            flip, err = compare_dense(g_k, g_p)
            lik_err = float((l_k - l_p).abs().max())
            ok = (err == 0.0 and launched == 1 and bool(torch.allclose(
                l_k, l_p, rtol=LIK_RTOL, atol=LIK_ATOL)))
            worst = max(worst, err, lik_err)
            emit({"phase": "kernel_vs_plain_k1_fleet", "mode": mode,
                  "dphi": "static" if static else "traced",
                  "shape": list(g_k.shape), "worlds": w,
                  "launches": launched, "flip_fraction": flip,
                  "grid_max_abs_err": err, "lik_max_abs_err": lik_err})
            if not ok:
                raise AssertionError(f"K1 over worlds disagrees with its "
                                     f"plain version ({mode}, static="
                                     f"{static}) or launched {launched}")
            del g_k, g_p, args
    args, kw = fleet_kernel_case(torch, spec, 1, w * p, 92, True)
    grids, poses, a0, dist, valid, present = args[:6]
    one = fused.fused_update(*args, **kw)
    single = fused.fused_update(grids, poses, a0[0], dist[0], valid[0],
                                present[0], *args[6:], **kw)
    equal = bool(torch.equal(one[0], single[0])
                 and torch.equal(one[1], single[1]))
    emit({"phase": "k1_one_world_vs_single_world", "shape":
          list(grids.shape), "bitwise_equal": equal})
    if not equal:
        raise AssertionError("a one-world K1 call differs from the "
                             "single-world call")
    return worst


def fleet_cow_plan(torch, seed=5):
    """The flattened plan of one fleet resample: per-world systematic
    resamples of peaked weights, ancestors offset by ``w * P``."""
    from slamrs_tpu_torch.ops import cow, resample

    w, p = FLEET_WORLDS, FLEET_PARTICLES
    g = torch.Generator(device="cuda").manual_seed(seed)
    weights = torch.softmax(torch.randn(w, p, generator=g, device="cuda")
                            * 3.0, -1)
    anc = resample.systematic_resample(
        weights, torch.rand(w, 1, generator=g, device="cuda"))
    flat = (anc + p * torch.arange(w, dtype=torch.int32,
                                   device="cuda")[:, None]).reshape(-1)
    return cow.cow_plan(flat)


def check_cow_fleet(torch):
    """K2 on the flattened 2,560-map plan of a fleet resample against its
    plain version, bitwise; every copy's source and destination in one
    world block.  Returns the kernels-line numbers of K2 at this plan."""
    from slamrs_tpu_torch.ops import cow

    p = FLEET_PARTICLES
    src, dst, n = fleet_cow_plan(torch)
    live = torch.arange(src.shape[0], device="cuda") < n
    in_world = bool(((src // p) == (dst // p))[live].all())
    g = torch.Generator(device="cuda").manual_seed(8)
    grids = torch.randn(src.shape[0], 200, 256, generator=g, device="cuda")
    before = cow.cow_copy.launches
    g_k = cow.cow_copy(grids.clone(), src, dst, n)
    torch.cuda.synchronize()
    launched = cow.cow_copy.launches - before
    g_p = cow.cow_copy_reference(grids.clone(), src, dst, n)
    equal = bool(torch.equal(g_k, g_p))
    n_host = n.cpu()
    nbytes = cow_bytes(torch, grids, src, n)
    ms = time_call(torch, lambda: cow.launch_kernel(grids, src, dst, n))
    plain_ms = time_call(torch, lambda: cow.cow_copy_reference(
        grids, src, dst, n_host))
    s_l, d_l = src.long(), dst.long()
    lib_ms = time_call(torch, lambda: grids.index_copy_(
        0, d_l, grids.index_select(0, s_l)))
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    emit({"phase": "cow_fleet_plan", "maps": list(grids.shape),
          "n_copies": int(n), "copies_in_their_world": in_world,
          "bitwise_equal": equal, "launches": launched, "bytes": nbytes,
          "kernel_ms": ms, "plain_ms": plain_ms, "index_copy_ms": lib_ms,
          "bound_ms": bound})
    if not (equal and in_world and launched == 1):
        raise AssertionError("K2 on the fleet plan disagrees with its plain "
                             "version or copies across worlds")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by="bytes")


def check_fleet_rollout(torch, fw, worlds, n_steps, label, est="grid_pose",
                        rmse_gate=None, expect=None, at_most=None):
    """Drive a fleet's ``rollout_cadence`` with every launch count set to
    0 just before and read just after.  ``expect`` maps counter names to
    a count, ``"frames"`` or ``"world_frames"``; ``at_most`` the same as
    upper bounds.  Gates: finite outputs, each world's weights summing to
    1, the RMSE of ``est`` over every world and frame."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = fw.rollout_cadence(fw.init((worlds,)), n_steps, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    frames = int(outs.fired.shape[0])
    sq = ((getattr(outs, est)[..., :2].float()
           - outs.pose[..., :2].float()) ** 2)
    rmse = float(torch.sqrt(sq.mean()))
    per_world = torch.sqrt(sq.mean(dim=(0, 2)))
    tensors = [outs.pose, getattr(outs, est)]
    wsum_err = 0.0
    if state.grid is not None:
        tensors += [outs.n_eff, state.grid.weights, state.grid.poses,
                    state.grid.grids]
        wsum_err = float((state.grid.weights.sum(-1) - 1.0).abs().max())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in tensors)
    emit({"phase": f"rollout_fleet_{label}", "worlds": worlds,
          "ticks": n_steps, "frames": frames, "launch_counts": counts,
          f"{est}_rmse_xy_m": rmse,
          "worst_world_rmse_xy_m": float(per_world.max()),
          "worst_world": int(per_world.argmax()),
          "weights_sum_max_err": wsum_err, "finite": finite,
          "seconds": seconds, "world_ticks_per_s": worlds * n_steps / seconds})

    def want(v):
        return {"frames": frames, "world_frames": worlds * frames}.get(v, v)

    for name, v in (expect or {}).items():
        if counts[name] != want(v):
            raise AssertionError(f"fleet {label}: {counts[name]} {name} "
                                 f"launches, expected {want(v)}")
    for name, v in (at_most or {}).items():
        if counts[name] > want(v):
            raise AssertionError(f"fleet {label}: {counts[name]} {name} "
                                 f"launches, more than {want(v)}")
    if not finite or wsum_err > 1e-5:
        raise AssertionError(f"fleet {label}: non-finite outputs or weights "
                             "not normalized")
    if rmse_gate is not None and not rmse <= rmse_gate:
        raise AssertionError(f"fleet {label}: RMSE {rmse} m > {rmse_gate} m")
    return counts, outs, state


def check_fleet_card_vs_cpu(torch):
    """A 4-world fleet at bench.py's fleet values for 60 ticks under the
    same numpy draws on the card and on the CPU: best poses within
    ``GRID_SLAM_CPU_GATE_M`` RMSE; the frames whose ancestors differ are
    printed."""
    from slamrs_tpu_torch.models import gridslam as gs

    w = (FLEET_CPU_WORLDS,)
    fw, cpu = fleet_world(torch), fleet_world(torch, device="cpu")
    noise = injected_grid_noise(fw, FLEET_CPU_TICKS, 9, w)
    kept, restore = recording_ancestors(gs)
    try:
        _, outs = fw.rollout_cadence(fw.init(w), FLEET_CPU_TICKS, seed=0,
                                     noise=noise)
        card_anc = [a.cpu() for a in kept]
        kept.clear()
        _, cpu_outs = cpu.rollout_cadence(cpu.init(w), FLEET_CPU_TICKS,
                                          seed=0, noise=noise)
        cpu_anc = list(kept)
    finally:
        restore()
    gap = pose_rmse(torch, outs.grid_pose.cpu().reshape(-1, 3),
                    cpu_outs.grid_pose.reshape(-1, 3))
    differ = [f for f, (a, b) in enumerate(zip(card_anc, cpu_anc))
              if not torch.equal(a, b)]
    emit({"phase": "fleet_card_vs_cpu", "worlds": w[0],
          "ticks": FLEET_CPU_TICKS, "frames": int(outs.fired.shape[0]),
          "card_vs_cpu_best_pose_rmse_m": gap,
          "frames_where_ancestors_differ": differ})
    if not gap <= GRID_SLAM_CPU_GATE_M:
        raise AssertionError(f"fleet card and CPU best poses differ by {gap} "
                             f"m RMSE")


def check_other_fleets(torch, icp_single_outs):
    """A small tiled fleet (K3 once per world a frame), ``grid_slam.yaml``
    at 16 worlds (dda, no kernel), ``icp_test.yaml`` at 8 worlds (K4 once
    an iteration for all worlds; the worlds, which draw nothing and see
    the same scans, bitwise equal, and within ``ICP_CPU_GATE_M`` of the
    single-world run) and ``landmarks.yaml`` at 8 worlds.  Returns the
    launch counts of the tiled and ICP fleets."""
    tiled = fleet_world(torch, position_x=-3.2, position_y=-6.4, width=6.4,
                        height=12.8, resolution=0.05, n_particles=64,
                        grid_dtype="bfloat16", resample_cow="tiled")
    tiled_counts, _, state = check_fleet_rollout(
        torch, tiled, 4, 60, "tiled_4x64_60", rmse_gate=RMSE_GATE_M,
        expect={"fused_update_tiled": "world_frames", "fused_update": 0,
                "cow_copy": 0})
    if state.grid.tile_table is None or state.grid.tile_table.dim() != 3:
        raise AssertionError("the tiled fleet holds no per-world tables")
    check_fleet_rollout(torch, preset_world(torch, "grid_slam.yaml"), 16, 300,
                        "grid_slam_yaml_16_300",
                        rmse_gate=GRID_SLAM_RMSE_GATE_M, expect=NO_KERNELS)
    icp_fw = preset_world(torch, "icp_test.yaml")
    icp_counts, outs, _ = check_fleet_rollout(
        torch, icp_fw, 8, 300, "icp_8_300", est="icp_pose",
        rmse_gate=ICP_RMSE_GATE_M,
        expect={"fused_update": 0, "fused_update_tiled": 0, "cow_copy": 0})
    if icp_counts["nn_argmin"] != icp_fw.icp_config.iterations \
            * outs.fired.shape[0]:
        raise AssertionError("the ICP fleet did not launch K4 once an "
                             "iteration for all worlds")
    # every world runs the same scans: the worlds agree bit for bit, and
    # with the single-world run up to the order of the batched products'
    # sums (cuBLAS picks other kernels for a batch), as the card and the
    # CPU do
    n = outs.icp_pose.shape[0]
    same = bool((outs.icp_pose == outs.icp_pose[:, :1]).all())
    gap = (outs.icp_pose - icp_single_outs.icp_pose[:n, None]).abs().amax(
        dim=(1, 2))
    emit({"phase": "icp_fleet_vs_single_world", "worlds": 8, "frames": n,
          "worlds_bitwise_equal": same, "max_pose_diff_m": float(gap.max()),
          "first_frame_diff_m": float(gap[0]),
          "per_frame_max_diff_m": [float(x) for x in gap[::8]]})
    if not (same and float(gap.max()) <= ICP_CPU_GATE_M):
        raise AssertionError(f"ICP fleet worlds differ from each other or "
                             f"from the single world by {float(gap.max())} m")
    check_fleet_rollout(torch, preset_world(torch, "landmarks.yaml"), 8, 300,
                        "ekf_8_300", est="ekf_pose",
                        rmse_gate=EKF_RMSE_GATE_M)
    return tiled_counts, icp_counts


def check_fleet_no_host_sync(torch):
    """One copy-on-write and one whole-set-gather fleet update at 256 x 10
    never wait for the card."""
    from slamrs_tpu_torch.core.types import OdometryReading
    from slamrs_tpu_torch.models import gridslam as gs
    from slamrs_tpu_torch.models.simulator import lidar_scan

    w = FLEET_WORLDS
    for label, kw in (("cow", {}), ("gather", {"fleet_resample": "gather"})):
        fw = fleet_world(torch, **kw)
        st = fw.init((w,)).grid
        pose = torch.zeros(w, 3, device="cuda")
        pose[:, 0] = torch.linspace(-0.5, 0.5, w, device="cuda")
        scan = lidar_scan(pose, fw.scene, 1.0, 360)
        odo = OdometryReading(torch.full((w,), 0.01, device="cuda"),
                              torch.full((w,), 0.012, device="cuda"),
                              fw.params.wheel_base)
        gen = torch.Generator(device="cuda").manual_seed(3)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, out = gs.update_fleet(st, scan, odo, fw.grid_config,
                                      generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        emit({"phase": f"no_host_sync_fleet_{label}", "ok": True,
              "pose_finite": bool(torch.isfinite(out.pose).all())})


def time_fleet(torch, spec):
    """K1 at the fleet shape (in place, the main path's mode): kernel,
    plain version and bound, the bound counting the scan discs' cells
    read and written once; then a warm 300-tick fleet run (world-ticks/s,
    peak memory) and a profiled one.  Returns K1's kernels-line
    numbers."""
    from slamrs_tpu_torch.ops import fused

    args, kw = fleet_kernel_case(torch, spec, FLEET_WORLDS, FLEET_PARTICLES,
                                 93, True, far=False)
    grids, poses, a0, dist, valid, present = args[:6]
    prep = fused.prepare(grids.shape[1], grids.shape[2], poses, a0, dist,
                         valid, present, spec, 360, 1.0, kw["dphi"])
    ms = time_call(torch, lambda: fused.launch_kernel(grids, None, prep,
                                                       spec, 360))
    plain_ms = time_call(torch, lambda: fused.plain_update(grids, prep, spec,
                                                           360))
    el = grids.element_size()
    cells = disc_cells(torch, spec, prep, grids.shape[2])
    bound, by = fused_bound(2 * cells * el, cells)
    box = box_cells(torch, prep, grids.shape[2], el)
    window = grids.shape[0] * prep.wr * grids.shape[2]
    emit({"phase": "kernel_time_k1_fleet", "shape": list(grids.shape),
          "worlds": FLEET_WORLDS, "mode": "in_place", "kernel_ms": ms,
          "plain_ms": plain_ms, "disc_cells": cells, "bound_ms": bound,
          "bound_by": by, "window_cells": window, "box_cells": box,
          "box_design_cost_ms": fused_bound(2 * box * el, box)[0],
          "g_box_cells_per_s": box / ms / 1e6})
    del grids, args

    fw = fleet_world(torch)
    w = (FLEET_WORLDS,)
    fw.rollout_cadence(fw.init(w), 30, seed=2)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, outs = fw.rollout_cadence(fw.init(w), 300, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    emit({"phase": "rollout_time_fleet_256x10_0.02m_300", "ticks": 300,
          "worlds": w[0], "frames": int(outs.fired.shape[0]),
          "seconds": seconds, "world_ticks_per_s": w[0] * 300 / seconds,
          "grid_pose_rmse_xy_m": pose_rmse(torch,
                                           outs.grid_pose.reshape(-1, 3),
                                           outs.pose.reshape(-1, 3)),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    del outs
    profile_rollout(torch, fw, "fleet_256x10_0.02m_300", kernel="fused",
                    worlds=w)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


# ---- sharded fleets: (world, particle) meshes of the one card ----------

MESH_HEADLINE_WORLDS = 2
MESH_CONFIG3_WORLDS, MESH_CONFIG3_TICKS = 2, 90
MESH_OTHER_WORLDS = 8


def cuda_mesh(torch, particle_axis, n=8):
    """An ``n``-entry mesh whose every entry is ``cuda:0``."""
    from slamrs_tpu_torch.parallel.fleet import make_mesh

    return make_mesh(n, particle_axis=particle_axis,
                     devices=[torch.device("cuda", 0)] * n)


def on_mesh(fw, mesh):
    import dataclasses

    return dataclasses.replace(fw, mesh=mesh)


def with_grid(fw, **kw):
    import dataclasses

    return dataclasses.replace(fw, grid_config=dataclasses.replace(
        fw.grid_config, **kw))


class FleetRun:
    """One fleet rollout: ``rollout_cadence`` from a fresh state (placed
    on ``fw.mesh`` first when it has one), the counts set to 0 just
    before and read just after; the final state whole.  ``peak`` is the
    run's own peak device memory: the most allocated during the rollout
    less what was allocated before its state was made."""

    def __init__(self, torch, fw, worlds, n_steps, seed=0):
        from slamrs_tpu_torch.parallel import fleet

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        state = fw.init((worlds,))
        if fw.mesh is not None:
            state = fleet.shard_world_state(state, fw.mesh, worlds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state, self.outs = fw.rollout_cadence(state, n_steps, seed=seed)
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t0
        self.counts = read_counts()
        self.peak = torch.cuda.max_memory_allocated() - base
        if fw.mesh is not None and fleet.mesh_of(state) != fw.mesh:
            raise AssertionError("a mesh world's rollout left its mesh")
        self.state = fleet.unshard_world_state(state)
        self.frames = int(self.outs.fired.shape[0])
        self.world_ticks_per_s = worlds * n_steps / self.seconds

    def summary(self):
        return {"seconds": self.seconds,
                "world_ticks_per_s": self.world_ticks_per_s,
                "peak_memory_bytes": self.peak,
                "launch_counts": self.counts}


def same_state(torch, a, b) -> bool:
    from slamrs_tpu_torch.parallel.fleet import tree_leaves

    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def same_run(torch, a, b) -> bool:
    return same_state(torch, a.state, b.state) and same_state(torch, a.outs,
                                                              b.outs)


def fleet_rmse(torch, outs, est="grid_pose"):
    err = getattr(outs, est)[..., :2].float() - outs.pose[..., :2].float()
    return float(torch.sqrt((err ** 2).mean()))


def same_multiset(torch, a, b) -> bool:
    """Per world, the same (pose, map) particles in any slot order."""
    for w in range(a.poses.shape[0]):
        keys = []
        for s in (a, b):
            rows = torch.cat([s.poses[w].float().flatten(1),
                              s.grids[w].float().flatten(1)], 1).cpu()
            keys.append(sorted(bytes(r.numpy()) for r in rows))
        if keys[0] != keys[1]:
            return False
    return True


class OverflowReads:
    """Counts the local-first resample's overflow reads (one a resample:
    every world shard's flag at once, its one host read) and the
    full-gather fallbacks they took (world shards); ``allow_sync`` lets
    exactly that read run under ``set_sync_debug_mode("error")``."""

    def __init__(self, torch, allow_sync=False):
        from slamrs_tpu_torch.parallel import resample

        self.torch, self.mod, self.allow = torch, resample, allow_sync
        self.reads = self.fallbacks = 0

    def __enter__(self):
        self.orig = self.mod._read_overflow

        def read(flags):
            mode = self.torch.cuda.get_sync_debug_mode()
            if self.allow:
                self.torch.cuda.set_sync_debug_mode("default")
            try:
                hits = self.orig(flags)
            finally:
                self.torch.cuda.set_sync_debug_mode(mode)
            self.reads += 1
            self.fallbacks += sum(hits)
            return hits

        self.mod._read_overflow = read
        return self

    def __exit__(self, *exc):
        self.mod._read_overflow = self.orig
        return False


def mesh_phase(label, sharded, plain=None, **fields):
    emit({"phase": f"mesh_{label}", **fields, "sharded": sharded.summary(),
          "unsharded": plain.summary() if plain is not None else None})


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def check_mesh_config5(torch):
    """BASELINE config 5 (256 x 10 at 0.02 m, f32) for 300 ticks: on an
    8 x 1 mesh (each world shard's flattened copy on write) bitwise the
    one-device fleet, K1 once per world shard a frame, K2 at most as
    often; on a 4 x 2 mesh (``"local"``, p_loc 5) within the fleet's
    RMSE gate, K1 once per block a frame, K2 never, one overflow read a
    frame (every world shard's flag at once).  Returns the two runs'
    counts."""
    fw = fleet_world(torch)
    plain = FleetRun(torch, fw, FLEET_WORLDS, 300)
    dp = FleetRun(torch, on_mesh(fw, cuda_mesh(torch, 1)), FLEET_WORLDS, 300)
    equal = same_run(torch, dp, plain)
    mesh_phase("config5_8x1_300", dp, plain, bitwise_equal=equal,
               frames=dp.frames)
    require(equal and dp.counts["fused_update"] == 8 * dp.frames
            and dp.counts["cow_copy"] <= 8 * dp.frames
            and dp.counts["fused_update_tiled"] == 0,
            "config 5 on 8 x 1 differs from the one-device fleet or its "
            "launch counts are off")
    with OverflowReads(torch) as ov:
        local = FleetRun(torch, on_mesh(fw, cuda_mesh(torch, 2)),
                         FLEET_WORLDS, 300)
    rmse = fleet_rmse(torch, local.outs)
    mesh_phase("config5_4x2_local_300", local, plain, frames=local.frames,
               grid_pose_rmse_xy_m=rmse,
               unsharded_grid_pose_rmse_xy_m=fleet_rmse(torch, plain.outs),
               overflow_reads=ov.reads, overflow_fallbacks=ov.fallbacks)
    require(rmse <= GRID_SLAM_RMSE_GATE_M
            and local.counts["fused_update"] == 8 * local.frames
            and local.counts["cow_copy"] == 0
            and ov.reads == local.frames,
            f"config 5 on 4 x 2: RMSE {rmse} m or launch counts off")
    return dp.counts, local.counts


def check_mesh_headline(torch):
    """2 worlds x 1,024 particles at 0.05 m (bf16 ``[80, 128]``) on a 2 x 4
    mesh: ``"gather"`` for 300 ticks bitwise the one-device fleet;
    ``"local"`` after one scan frame the per-world multiset of
    ``"gather"``, over 300 ticks within the headline's RMSE gate, its
    overflow fallbacks (p_loc 256 against a spill cap of 8) counted.
    Returns the gather run's counts."""
    w = MESH_HEADLINE_WORLDS
    local_fw = headline_world(torch, 0.05)
    gather_fw = with_grid(local_fw, fleet_resample="gather")
    mesh = cuda_mesh(torch, 4)
    first = [FleetRun(torch, on_mesh(f, mesh), w, 7)
             for f in (local_fw, gather_fw)]
    multiset = (first[0].frames == 1 and same_multiset(
        torch, first[0].state.grid, first[1].state.grid))
    emit({"phase": "mesh_headline_2x4_local_first_frame",
          "frames": first[0].frames, "same_multiset_as_gather": multiset})
    require(multiset, "local and gather hold other particles after the "
            "first frame")
    plain = FleetRun(torch, gather_fw, w, 300)
    gather = FleetRun(torch, on_mesh(gather_fw, mesh), w, 300)
    equal = same_run(torch, gather, plain)
    mesh_phase("headline_2x4_gather_300", gather, plain, bitwise_equal=equal,
               frames=gather.frames)
    require(equal and gather.counts["fused_update"] == 8 * gather.frames
            and gather.counts["cow_copy"] == 0,
            "the headline on 2 x 4 (gather) differs from the one-device "
            "fleet or its K1 count is off")
    plain = FleetRun(torch, local_fw, w, 300)  # one device: copy on write
    with OverflowReads(torch) as ov:
        local = FleetRun(torch, on_mesh(local_fw, mesh), w, 300)
    rmse = fleet_rmse(torch, local.outs)
    mesh_phase("headline_2x4_local_300", local, plain, frames=local.frames,
               grid_pose_rmse_xy_m=rmse,
               unsharded_grid_pose_rmse_xy_m=fleet_rmse(torch, plain.outs),
               overflow_reads=ov.reads, overflow_fallbacks=ov.fallbacks)
    require(rmse <= RMSE_GATE_M
            and local.counts["fused_update"] == 8 * local.frames
            and ov.reads == local.frames,
            f"the headline on 2 x 4 (local): RMSE {rmse} m or counts off")
    return gather.counts


def check_mesh_config3(torch):
    """Two worlds of BASELINE config 3 (tiled: a 2.35 GB pool each) on a
    2 x 1 mesh for 90 ticks: bitwise the one-device tiled fleet, K3 once
    per world a frame.  Returns the counts."""
    fw = config3_world(torch)
    w = MESH_CONFIG3_WORLDS
    plain = FleetRun(torch, fw, w, MESH_CONFIG3_TICKS)
    sharded = FleetRun(torch, on_mesh(fw, cuda_mesh(torch, 1, n=2)), w,
                       MESH_CONFIG3_TICKS)
    equal = same_run(torch, sharded, plain)
    mesh_phase("config3_tiled_2x1_90", sharded, plain, bitwise_equal=equal,
               frames=sharded.frames,
               pool=list(sharded.state.grid.grids.shape))
    require(equal and sharded.state.grid.tile_table is not None
            and sharded.counts["fused_update_tiled"] == w * sharded.frames
            and sharded.counts["fused_update"] == 0,
            "config 3 on 2 x 1 differs from the one-device tiled fleet or "
            "K3 did not run once per world a frame")
    del plain
    return sharded.counts


def check_mesh_other_filters(torch):
    """``grid_slam.yaml`` (dda) at 16 worlds on 4 x 2 for 300 ticks,
    bitwise the one-device fleet, no kernel; ``icp_test.yaml`` and
    ``landmarks.yaml`` at 8 worlds on 4 x 1 for 300 ticks against the
    one-device fleets: ICP poses within 2e-3 m every frame (K4 at ``b =
    W_loc``, ten launches per world shard a frame) and the RMSE gates
    of phases 14 and 15 (the EKF's batched products sum in another order
    at another batch, and its float32 chaos grows the gap, so the gap is
    printed, as phase 28's fleet check does).  Returns the ICP run's
    counts."""
    fw = preset_world(torch, "grid_slam.yaml")
    plain = FleetRun(torch, fw, 16, 300)
    sharded = FleetRun(torch, on_mesh(fw, cuda_mesh(torch, 2)), 16, 300)
    equal = same_run(torch, sharded, plain)
    mesh_phase("grid_slam_yaml_4x2_300", sharded, plain, bitwise_equal=equal,
               frames=sharded.frames)
    require(equal and not any(slam_counts(sharded.counts).values())
            and sharded.counts["sim_frame"] == sim_launches(fw, 300, rows=4),
            "grid_slam.yaml on 4 x 2 differs from the one-device fleet or "
            "launched a kernel")
    mesh = cuda_mesh(torch, 1, n=4)
    icp_counts = None
    for name, est, gate in (("icp_test.yaml", "icp_pose", ICP_RMSE_GATE_M),
                            ("landmarks.yaml", "ekf_pose", EKF_RMSE_GATE_M)):
        fw = preset_world(torch, name)
        plain = FleetRun(torch, fw, MESH_OTHER_WORLDS, 300)
        sharded = FleetRun(torch, on_mesh(fw, mesh), MESH_OTHER_WORLDS, 300)
        gap = float((getattr(sharded.outs, est)[..., :2]
                     - getattr(plain.outs, est)[..., :2]).abs().max())
        rmse = fleet_rmse(torch, sharded.outs, est)
        mesh_phase(f"{name.split('.')[0]}_4x1_300", sharded, plain,
                   frames=sharded.frames, max_pose_diff_m=gap,
                   rmse_xy_m=rmse, bitwise_equal=same_run(torch, sharded,
                                                          plain))
        require((gap <= ICP_CPU_GATE_M or est != "icp_pose")
                and rmse <= gate,
                f"{name} on 4 x 1: {gap} m from the one-device fleet, RMSE "
                f"{rmse} m")
        if est == "icp_pose":
            icp_counts = sharded.counts
            require(sharded.counts["nn_argmin"]
                    == 4 * fw.icp_config.iterations * sharded.frames,
                    "the ICP fleet on 4 x 1 did not launch K4 once an "
                    "iteration per world shard")
    return icp_counts


def flagship(torch, particles, width, integrate, mesh, **kw):
    """``__graft_entry__._flagship``: the fused world at ``width`` m, 0.05 m
    cells, 360 beams, a scan every tick."""
    from slamrs_tpu_torch.graph.compile import make_fused
    from slamrs_tpu_torch.models.gridslam import GridSlamConfig
    from slamrs_tpu_torch.models.simulator import SimParams

    cfg = GridSlamConfig(position_x=-width / 2, position_y=-width / 2,
                         width=width, height=width, resolution=0.05,
                         n_particles=particles, max_scan_range=1.0,
                         resample_neff_frac=1.0, integrate=integrate, **kw)
    return make_fused(params=SimParams.make(update_period=0.0),
                      grid_config=cfg, num_beams=360, mesh=mesh,
                      device=mesh.first_device)


def check_mesh_dryrun_legs(torch):
    """The JAX package's ``dryrun_multichip(8)`` legs
    (``__graft_entry__.py:86-199``) on an 8-entry mesh of the card, one
    step each: dda (256 particles, 4 x 4 m) and fused (64, bf16, the
    local relabel) at 4 worlds on 2 x 4, tiled at config-3 geometry (8
    particles, 50 x 50 m) at 8 worlds on 8 x 1.  Gates: the scan fires,
    poses ``[W, 3]``, the maps on all 8 blocks (tiled: one pool per
    world shard, tables present), finite n_eff; the dda and tiled steps
    bitwise the one-device step."""
    from slamrs_tpu_torch.core.types import Command
    from slamrs_tpu_torch.parallel import fleet

    mesh24, mesh81 = cuda_mesh(torch, 4), cuda_mesh(torch, 1)
    legs = {"dda": (flagship(torch, 256, 4.0, "dda", mesh24), 4),
            "fused": (flagship(torch, 64, 4.0, "fused", mesh24,
                               grid_dtype="bfloat16"), 4),
            "tiled": (flagship(torch, 8, 50.0, "fused", mesh81,
                               grid_dtype="bfloat16", resample_cow="tiled"),
                      8)}
    cmd = Command(torch.tensor(0.05, device="cuda"),
                  torch.tensor(0.08, device="cuda"))
    out = {}
    for name, (fw, w) in legs.items():
        reset_counts()
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, row = fw.step(fw.init((w,)), cmd, generator=gen)
        torch.cuda.synchronize()
        counts = read_counts()
        grid = state.grid
        blocks = sum(len(r) for r in grid.grids.blocks)
        ok = (row.fired and tuple(state.pose.shape) == (w, 3)
              and blocks == 8
              and (grid.tile_table is not None) == (name == "tiled")
              and bool(torch.isfinite(row.n_eff).all()))
        equal = None
        if name != "fused":
            plain = on_mesh(fw, None)
            p_state, p_row = plain.step(
                plain.init((w,)), cmd,
                generator=torch.Generator(device="cuda").manual_seed(0))
            equal = (same_state(torch, fleet.unshard_world_state(state),
                                p_state)
                     and torch.equal(row.grid_pose, p_row.grid_pose))
            ok = ok and equal
        out[name] = [float(x) for x in row.n_eff]
        emit({"phase": f"mesh_dryrun_{name}", "worlds": w,
              "mesh": fleet.mesh_of(state).shape, "grid_blocks": blocks,
              "launch_counts": counts, "n_eff": out[name],
              "bitwise_equal_unsharded": equal, "ok": ok})
        require(ok, f"the dryrun leg {name} failed")
    return out


def check_mesh_checkpoint(torch, tmp):
    """A sharded config-5 fleet (16 worlds, 4 x 2, ``"local"``) after 30
    ticks: saved in the one-device layout (the leaves of saving its
    unsharded state), loaded onto its template's mesh, and 60 resumed
    ticks bitwise 60 ticks continued in memory."""
    import numpy as np

    from slamrs_tpu_torch.parallel import fleet
    from slamrs_tpu_torch.utils import checkpoint

    mesh = cuda_mesh(torch, 2)
    fw = on_mesh(fleet_world(torch), mesh)
    state, _ = fw.rollout_cadence(fw.init((16,)), 30, seed=1)
    sharded, whole = Path(tmp) / "sharded.npz", Path(tmp) / "whole.npz"
    checkpoint.save(str(sharded), state)
    checkpoint.save(str(whole), fleet.unshard_world_state(state))
    with np.load(sharded) as a, np.load(whole) as b:
        same_file = a.files == b.files and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            for k in a.files)
    loaded = checkpoint.load(str(sharded), fleet.shard_world_state(
        fw.init((16,)), mesh, 16))
    on_its_mesh = fleet.mesh_of(loaded) == mesh
    resumed, r_outs = fw.rollout_cadence(loaded, 60, seed=2)
    kept, k_outs = fw.rollout_cadence(state, 60, seed=2)
    equal = (same_state(torch, fleet.unshard_world_state(resumed),
                        fleet.unshard_world_state(kept))
             and same_state(torch, r_outs, k_outs))
    emit({"phase": "mesh_checkpoint", "bytes": sharded.stat().st_size,
          "same_leaves_as_unsharded_save": same_file,
          "loaded_on_the_mesh": on_its_mesh, "resumed_equals_continued":
          equal})
    require(same_file and on_its_mesh and equal,
            "the sharded checkpoint does not round-trip")


def check_mesh_no_host_sync(torch):
    """One update per mesh route under ``set_sync_debug_mode("error")``:
    config 5 on 8 x 1 (copy on write per world shard), the headline's 2
    worlds on 2 x 4 (``"gather"`` and ``"local"``: only the overflow
    read, once for both world shards, is let through), a tiled fleet on
    2 x 1
    and ``grid_slam.yaml`` (dda) at 16 worlds on 4 x 2."""
    from slamrs_tpu_torch.core.types import OdometryReading
    from slamrs_tpu_torch.models import gridslam as gs
    from slamrs_tpu_torch.models.simulator import lidar_scan
    from slamrs_tpu_torch.parallel import fleet

    headline = headline_world(torch, 0.05)
    tiled = fleet_world(torch, position_x=-3.2, position_y=-6.4, width=6.4,
                        height=12.8, resolution=0.05, n_particles=64,
                        grid_dtype="bfloat16", resample_cow="tiled")
    routes = {"config5_8x1": (fleet_world(torch), FLEET_WORLDS, 1, 8),
              "headline_2x4_gather": (with_grid(headline,
                                                fleet_resample="gather"),
                                      2, 4, 8),
              "headline_2x4_local": (headline, 2, 4, 8),
              "tiled_2x1": (tiled, 2, 1, 2),
              "grid_slam_yaml_4x2": (preset_world(torch, "grid_slam.yaml"),
                                     16, 2, 8)}
    for label, (fw, w, axis, n) in routes.items():
        mesh = cuda_mesh(torch, axis, n)
        st = fleet.shard_world_state(fw.init((w,)), mesh, w).grid
        pose = torch.zeros(w, 3, device="cuda")
        pose[:, 0] = torch.linspace(-0.5, 0.5, w, device="cuda")
        scan = lidar_scan(pose, fw.scene, 1.0, fw.num_beams)
        odo = OdometryReading(torch.full((w,), 0.01, device="cuda"),
                              torch.full((w,), 0.012, device="cuda"),
                              fw.params.wheel_base)
        gen = torch.Generator(device="cuda").manual_seed(3)
        torch.cuda.synchronize()
        with OverflowReads(torch, allow_sync=True) as ov:
            torch.cuda.set_sync_debug_mode("error")
            try:
                st, out = gs.update_fleet(st, scan, odo, fw.grid_config,
                                          generator=gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        want_reads = 1 if label == "headline_2x4_local" else 0
        emit({"phase": f"mesh_no_host_sync_{label}", "ok": True,
              "overflow_reads": ov.reads,
              "pose_finite": bool(torch.isfinite(out.pose).all())})
        require(ov.reads == want_reads and bool(
            torch.isfinite(out.pose).all()),
            f"{label}: {ov.reads} overflow reads, expected {want_reads}")


# ---- the host graph: App, its nodes and the CLI ------------------------

# preset -> (its SLAM node's class, the topic that node publishes its pose on)
APP_PRESETS = {"grid_slam_fused.yaml": ("GridMapSlamNode", "robot/pose"),
               "icp_test.yaml": ("IcpPointMapperNode", "robot/pose"),
               "grid_slam.yaml": ("GridMapSlamNode", "robot/pose"),
               "landmarks.yaml": ("EKFLandmarkSlamNode", "slam/pose")}
EKF_APP_RMSE_GATE_M = 0.03


class SpanTimes:
    """The durations (ms) of one span's closes, read from the debug log
    that ``utils/trace.span`` writes when a span closes."""

    def __init__(self, name):
        import logging

        self.name = name
        self.ms = []
        self.handler = logging.Handler(logging.DEBUG)
        self.handler.emit = self._record
        self.logger = logging.getLogger("slamrs_tpu_torch")

    def _record(self, record):
        if record.args and record.args[0] == self.name:
            self.ms.append(float(record.args[1]))

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(10)  # DEBUG
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)
        return False


def drive_app(torch, name, frames, device="cuda", grid_noise=None):
    """``App.from_file(configs/name)`` on ``device`` for ``frames``
    frames, with every launch count set to 0 just before and read just
    after.  ``grid_noise`` (eps_c, eps_t, u01 with a leading update axis,
    numpy) replaces the grid node's draws.  Returns the app, its SLAM
    node, the counts, the seconds, and per SLAM update the published
    pose and the simulator's pose at that frame (the scan's pose)."""
    import numpy as np

    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.graph.nodes import slam
    from slamrs_tpu_torch.graph.nodes.sim import SimulatorNode
    from slamrs_tpu_torch.models.gridslam import UpdateNoise

    root = Path(__file__).resolve().parent
    app = App.from_file(str(root / "configs" / name), device=device)
    cls_name, topic = APP_PRESETS[name]
    node = app.node(getattr(slam, cls_name))
    sim = app.node(SimulatorNode)
    if grid_noise is not None:
        node.noise_for_update = lambda i: UpdateNoise(
            *(torch.from_numpy(x[i]).to(node.device) for x in grid_noise))
    published = app.pubsub.subscribe(topic)
    truth = []
    reset_counts()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        n = node.updates
        app.frame()
        if node.updates != n:
            truth.append(sim.state.pose.clone())
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    est = np.array([m.pose for m in published.drain()])
    truth = torch.stack(truth).cpu().numpy()
    return app, node, counts, seconds, est, truth


def xy_rmse(a, b) -> float:
    import numpy as np

    return float(np.sqrt(((a[:, :2] - b[:, :2]) ** 2).mean()))


def check_app_grid_slam_fused(torch):
    """``configs/grid_slam_fused.yaml`` at its full size through the App
    for 300 frames: K1 once per SLAM update (lineage mode), K2, K3 and K4
    never; the published best pose against the simulator's ground truth
    at the headline's RMSE gate; the published map unpadded."""
    from slamrs_tpu_torch.graph.nodes.viz import VisualizerNode
    from slamrs_tpu_torch.utils import trace

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    trace.stats("GridMapSlam::update").reset()  # this run's updates alone
    with SpanTimes("GridMapSlam::update") as spans:
        app, node, counts, seconds, est, truth = drive_app(
            torch, "grid_slam_fused.yaml", 300)
    m = app.node(VisualizerNode).latest("slam/map")
    rmse = xy_rmse(est, truth)
    emit({"phase": "app_grid_slam_fused_300", "frames": 300,
          "updates": node.updates, "launch_counts": counts,
          "k1_launches_per_frame": counts["fused_update"] / 300,
          "grids": list(node.state.grids.shape),
          "grid_dtype": str(node.state.grids.dtype),
          "grid_pose_rmse_xy_m": rmse, "map_shape": list(m.data.shape),
          "seconds": seconds, "frames_per_s": 300 / seconds,
          "update_span_median_ms": statistics.median(spans.ms),
          "update_span_mean_ms": node.stats.mean,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "peak_above_held_bytes": torch.cuda.max_memory_allocated() - held})
    want = {"fused_update": node.updates, "fused_update_in_place": 0,
            "cow_copy": 0, "fused_update_tiled": 0, "nn_argmin": 0,
            "icp_solve": 0, "sim_frame": sim_ticks(app)}
    if counts != want or node.updates < 45 or len(spans.ms) != node.updates:
        raise AssertionError(f"app headline launches {counts}, expected "
                             f"{want} ({len(spans.ms)} spans)")
    if not rmse <= RMSE_GATE_M or m.data.shape != (80, 80):
        raise AssertionError(f"app headline RMSE {rmse} m, map "
                             f"{m.data.shape}")
    return counts


def check_app_icp(torch):
    """``configs/icp_test.yaml`` through the App for 900 frames: K4 ten
    times an update, the ICP gate against ground truth, and the first 300
    frames on the CPU within the card-vs-CPU gate at every update."""
    import numpy as np

    _, node, counts, seconds, est, truth = drive_app(torch, "icp_test.yaml",
                                                     900)
    iters = node.map_cfg.iterations
    rmse = xy_rmse(est, truth)
    t0 = time.perf_counter()
    _, cpu_node, _, _, cpu_est, _ = drive_app(torch, "icp_test.yaml", 300,
                                              device="cpu")
    cpu_s = time.perf_counter() - t0
    gap = np.abs(est[:len(cpu_est)] - cpu_est).max(axis=1)
    emit({"phase": "app_icp_test_900", "frames": 900,
          "updates": node.updates, "launch_counts": counts,
          "k4_launches_per_frame": counts["nn_argmin"] / 900,
          "map_count": int(node.state.count), "icp_pose_rmse_xy_m": rmse,
          "seconds": seconds, "frames_per_s": 900 / seconds,
          "cpu_updates": cpu_node.updates, "cpu_seconds": cpu_s,
          "card_vs_cpu_max_pose_diff_m": float(gap.max())})
    if counts["nn_argmin"] != iters * node.updates or \
            counts["fused_update"] or counts["fused_update_tiled"]:
        raise AssertionError(f"app ICP launches {counts}, expected "
                             f"{iters} x {node.updates} nn_argmin")
    if not rmse <= ICP_RMSE_GATE_M:
        raise AssertionError(f"app ICP RMSE {rmse} m > {ICP_RMSE_GATE_M} m")
    if not gap.max() <= ICP_CPU_GATE_M:
        raise AssertionError(f"app ICP card vs CPU: {gap.max()} m")
    return counts


def check_app_grid_slam_yaml(torch):
    """``configs/grid_slam.yaml`` (dda) through the App for 300 frames on
    the card and on the CPU under the same numpy draws: no kernel, best
    poses within 2 cells RMSE of each other."""
    import numpy as np

    rng = np.random.default_rng(8)
    noise = (rng.standard_normal((12, 10)).astype(np.float32),
             rng.standard_normal((12, 10)).astype(np.float32),
             rng.random((12, 1)).astype(np.float32))
    app, node, counts, seconds, est, truth = drive_app(
        torch, "grid_slam.yaml", 300, grid_noise=noise)
    _, _, _, cpu_s, cpu_est, _ = drive_app(torch, "grid_slam.yaml", 300,
                                           device="cpu", grid_noise=noise)
    gap = xy_rmse(est, cpu_est)
    rmse = xy_rmse(est, truth)
    emit({"phase": "app_grid_slam_yaml_300", "frames": 300,
          "updates": node.updates, "launch_counts": counts,
          "grid_pose_rmse_xy_m": rmse, "card_vs_cpu_best_pose_rmse_m": gap,
          "seconds": seconds, "frames_per_s": 300 / seconds,
          "cpu_seconds": cpu_s})
    if any(slam_counts(counts).values()) or node.updates != len(cpu_est) \
            or counts["sim_frame"] != sim_ticks(app):
        raise AssertionError(f"app dda launches {counts}")
    if not gap <= GRID_SLAM_CPU_GATE_M or not rmse <= GRID_SLAM_RMSE_GATE_M:
        raise AssertionError(f"app dda: card vs CPU {gap} m, RMSE {rmse} m")


def check_app_landmarks(torch):
    """``configs/landmarks.yaml`` through the App for 300 frames: the EKF
    gate against ground truth, no kernel."""
    app, node, counts, seconds, est, truth = drive_app(
        torch, "landmarks.yaml", 300)
    rmse = xy_rmse(est, truth)
    emit({"phase": "app_landmarks_300", "frames": 300,
          "updates": node.updates, "launch_counts": counts,
          "ekf_pose_rmse_xy_m": rmse, "seconds": seconds,
          "frames_per_s": 300 / seconds})
    if any(slam_counts(counts).values()) \
            or counts["sim_frame"] != sim_ticks(app) \
            or not rmse <= EKF_APP_RMSE_GATE_M:
        raise AssertionError(f"app EKF RMSE {rmse} m, launches {counts}")


def check_app_no_host_sync(torch):
    """The headline App, captured: frames until every graph has been
    captured and replayed (the simulator's idle and firing ticks, the
    SLAM update and its map), then 30 idle frames and one frame whose
    tick fires and whose SLAM update publishes its pose and map, every
    node update a replay, under ``torch.cuda.set_sync_debug_mode(
    "error")``."""
    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.graph.nodes.sim import SimulatorNode
    from slamrs_tpu_torch.graph.nodes.slam import GridMapSlamNode
    from slamrs_tpu_torch.graph.nodes.viz import VisualizerNode

    root = Path(__file__).resolve().parent
    app = App.from_file(str(root / "configs" / "grid_slam_fused.yaml"),
                        device="cuda")
    sim, node = app.node(SimulatorNode), app.node(GridMapSlamNode)
    node.cfg.publish_map_every = 2
    # the map graph replays from the 4th update; the next update maps
    while node.updates < 5 or node.updates % 2 == 0:
        app.frame()
    sim.set_parameters(update_period=1e6)
    eager = {k: s.eager for k, s in app.program_stats().items()}
    replays = {k: s.replays for k, s in app.program_stats().items()}
    poses = app.pubsub.subscribe("robot/pose")
    maps = app.pubsub.subscribe("slam/map")
    ticks = sim.ticks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(30):
            app.frame()
        idle = sim.ticks
        sim.set_parameters(update_period=0.0)
        app.frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    msgs = poses.drain()
    stats = app.program_stats()
    emit({"phase": "app_no_host_sync", "idle_ticks": idle - ticks,
          "updates": node.updates, "poses_published": len(msgs),
          "maps_published": len(maps.drain()),
          "replays": {k: s.replays - replays[k] for k, s in stats.items()},
          "eager_runs": {k: s.eager - eager[k] for k, s in stats.items()},
          "map_shape": list(app.node(VisualizerNode).latest("slam/map")
                            .data.shape),
          "pose": [float(v) for v in msgs[0].pose]})
    require(sim.ticks == idle + 1 and len(msgs) == 1,
            "app_no_host_sync did not run its ticks")
    require(all(s.eager == eager[k] for k, s in stats.items()),
            f"app_no_host_sync: a node ran eagerly ({stats})")
    require(stats["SimulatorNode"].replays - replays["SimulatorNode"]
            == sim.ticks - ticks and stats["GridMapSlamNode"].replays
            - replays["GridMapSlamNode"] == 2,
            f"app_no_host_sync: replays {stats}")


def check_app_no_host_sync_icp_ekf(torch):
    """``landmarks.yaml`` and ``icp_test.yaml`` captured, warmed until
    their graphs replay: 60 frames of the EKF App under
    ``set_sync_debug_mode("error")``, and 60 of the ICP App under
    ``"warn"`` with every warning recorded, which must be the ICP node's
    count read alone, once an update."""
    import warnings

    from slamrs_tpu_torch.graph.app import App

    root = Path(__file__).resolve().parent
    fields = {"phase": "app_no_host_sync_icp_ekf", "frames": 60}
    for name, mode in (("landmarks.yaml", "error"), ("icp_test.yaml",
                                                      "warn")):
        app = App.from_file(str(root / "configs" / name), device="cuda")
        node = app_slam_node(app)
        while node.updates < 2:
            app.frame()
        before = node.updates
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(mode)
            try:
                app.run(frames=60)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        updates = node.updates - before
        stats = app.program_stats()
        fields[name] = {"updates": updates, "syncs": syncs,
                        "eager_runs": {k: v.eager for k, v in stats.items()},
                        "replays": {k: v.replays for k, v in stats.items()}}
        want = updates if name == "icp_test.yaml" else 0
        require(updates >= 9 and syncs == want,
                f"app_no_host_sync {name}: {syncs} syncs over {updates} "
                "updates")
    emit(fields)


def profile_app(torch, name, frames, text=None):
    """Device busy time, idle share and launches a frame of a profiled
    App run of ``frames`` frames, of ``configs/name`` or of the YAML
    ``text``."""
    from torch.profiler import ProfilerActivity, profile

    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.utils import trace

    root = Path(__file__).resolve().parent
    app = (App.from_yaml(text, device="cuda") if text is not None
           else App.from_file(str(root / "configs" / name), device="cuda"))
    app.run(frames=3)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        app.run(frames=frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a span (``utils/trace.span``) is a record_function range, which the
    # profiler also lays on the device's timeline: count kernels only
    spans = set(trace.all_stats())
    device = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.key not in spans]
    device_s = sum(e.self_device_time_total for e in device) / 1e6
    launches = sum(e.count for e in device)
    top = max(device, key=lambda e: e.self_device_time_total)
    emit({"phase": f"profile_app_{name}_{frames}", "wall_s_profiled": wall,
          "device_busy_s": device_s, "idle_share": 1 - device_s / wall,
          "kernel_launches": launches, "launches_per_frame": launches / frames,
          "top_kernel": top.key[:60],
          "top_kernel_s": top.self_device_time_total / 1e6})


def check_cli_run(torch, tmp):
    """``python -m slamrs_tpu_torch run configs/grid_slam_fused.yaml
    --duration 2 --npz``, in a process of its own on the card."""
    import numpy as np

    root = Path(__file__).resolve().parent
    out = Path(tmp) / "run.npz"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "slamrs_tpu_torch", "run",
         str(root / "configs" / "grid_slam_fused.yaml"), "--duration", "2",
         "--npz", str(out)], cwd=root, capture_output=True, text=True,
        timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"run exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    with np.load(out) as data:
        keys = sorted(data.files)
        shape = list(data["slam_map_grid"].shape)
    emit({"phase": "cli_run", "seconds": seconds, "npz_keys": keys,
          "slam_map_grid": shape, "stdout": proc.stdout.strip()[-300:]})
    if shape != [80, 80]:
        raise AssertionError(f"run --npz saved a {shape} map")


def check_checkpoint_card(torch, tmp):
    """``rollout --save-state`` then ``--resume`` on the headline preset:
    the saved state equals the in-memory state of the same run bitwise
    (bf16 maps included) and round-trips bitwise, and 60 resumed ticks
    equal 60 ticks continued from the in-memory state, same seed."""
    import contextlib
    import io

    from slamrs_tpu_torch.__main__ import main as cli
    from slamrs_tpu_torch.utils import checkpoint

    root = Path(__file__).resolve().parent
    cfg = str(root / "configs" / "grid_slam_fused.yaml")
    path = str(Path(tmp) / "headline.npz")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli(["rollout", cfg, "--steps", "60", "--save-state", path])
    save_s = time.perf_counter() - t0
    fw = preset_world(torch, "grid_slam_fused.yaml")
    state, _ = fw.rollout_cadence(fw.init(), 60, seed=0)
    loaded = checkpoint.load(path, fw.init())

    def same(a, b):
        la, lb = checkpoint.leaves(a), checkpoint.leaves(b)
        return len(la) == len(lb) and all(
            (x.dtype == y.dtype and torch.equal(x, y))
            if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(la, lb))

    saved_equal = same(loaded, state)
    again = Path(tmp) / "again.npz"
    checkpoint.save(str(again), loaded)
    round_trip = same(checkpoint.load(str(again), fw.init()), loaded)
    with contextlib.redirect_stdout(out):
        cli(["rollout", cfg, "--steps", "60", "--resume", path])
    reports = [json.loads(line) for line in out.getvalue().splitlines()]
    cont, outs = fw.rollout_cadence(state, 60, seed=0)
    resumed, routs = fw.rollout_cadence(loaded, 60, seed=0)
    resumed_equal = same(resumed, cont) and all(
        torch.equal(x, y) for x, y in zip(routs, outs) if x is not None)
    cli_equal = reports[1]["final_pose"] == cont.pose.tolist()
    emit({"phase": "checkpoint_card", "bytes": Path(path).stat().st_size,
          "grids": list(loaded.grid.grids.shape),
          "grid_dtype": str(loaded.grid.grids.dtype),
          "leaves": len(checkpoint.leaves(loaded)),
          "cli_save_seconds": save_s, "saved_equals_memory": saved_equal,
          "round_trip_bitwise": round_trip,
          "resumed_60_equal": resumed_equal, "cli_resume_equal": cli_equal})
    if not (saved_equal and round_trip and resumed_equal and cli_equal):
        raise AssertionError("checkpoint_card: a resumed state differs")


# the robot I/O: the virtual robot's command script and recording, the
# replay's and the link's gates
ROBOT_START = (-1.0, -1.2, 0.0)
ROBOT_SECONDS = 15.0
ROBOT_DT = 0.05
REPLAY_ICP_RMSE_GATE_M = 0.01
LINK_MIN_MESSAGES = 20
LINK_WALL_S = 60.0


def drive_robot(torch, device):
    """The port's virtual robot on ``device`` in ``cmd_robot``'s scene,
    from ``ROBOT_START``: ``NeatoOn``, ``SetDownsampling{0}``,
    ``Drive(0.10, 0.12)``, stepped ``ROBOT_SECONDS`` at ``ROBOT_DT``.
    Returns its outbox, the true pose at each ScanFrame, the seconds."""
    import numpy as np

    from slamrs_tpu_torch.__main__ import ROBOT_LINES, ROBOT_RECTS
    from slamrs_tpu_torch.io.message import CommandMessage
    from slamrs_tpu_torch.io.virtual_robot import VirtualRobot
    from slamrs_tpu_torch.models.simulator import Scene

    robot = VirtualRobot(scene=Scene.build(rects=ROBOT_RECTS,
                                           lines=ROBOT_LINES),
                         scanner_range=5.0, device=device)
    robot.pose = np.array(ROBOT_START)
    robot.connect()
    for m in (CommandMessage.neato_on(), CommandMessage.set_downsampling(0),
              CommandMessage.drive(0.10, 0.12)):
        robot.handle_command(m)
    truth = []
    rev = robot._lidar_rev

    def rev_with_truth():
        n = len(robot.outbox)
        rev()
        if len(robot.outbox) > n:
            truth.append(robot.pose.copy())

    robot._lidar_rev = rev_with_truth
    t0 = time.perf_counter()
    for _ in range(int(round(ROBOT_SECONDS / ROBOT_DT))):
        robot.step(ROBOT_DT)
    return list(robot.outbox), np.array(truth), time.perf_counter() - t0


def scan_frames(outbox):
    from slamrs_tpu_torch.io.message import RobotMessage

    return [RobotMessage.decode(raw)[0].scan_frame for raw in outbox
            if raw[:1] == b"\x00"]


def wire_stream(seed, n=200):
    """``n`` RobotMessages (ScanFrames with random scans, odometry and
    rpm, and Pongs), a malformed byte after about one in ten."""
    import numpy as np

    from slamrs_tpu_torch.io.message import RobotMessage, ScanFrame

    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n):
        if rng.random() < 0.2:
            parts.append(RobotMessage.pong().encode())
        else:
            odo = tuple(float(np.float32(v)) for v in rng.normal(0, .05, 2))
            parts.append(RobotMessage.from_scan(ScanFrame(
                rng.integers(0, 256, 1980, np.uint8).tobytes(), odo,
                int(rng.choice([0, 251, 300, 0xFFFF])))).encode())
        if rng.random() < 0.1:
            parts.append(bytes([int(rng.choice([2, 7, 200, 251, 254]))]))
    return b"".join(parts)


def drain_stream(stream, cuts, use_native):
    """``RobotLink._drain`` over ``stream`` fed in pieces cut at ``cuts``,
    through the native codec or the python decoder; returns the frames
    (odometry as its bytes: a resync can read NaNs) and the bytes left."""
    import struct

    from slamrs_tpu_torch import native
    from slamrs_tpu_torch.io.connection import RobotLink

    got = []
    link = RobotLink.__new__(RobotLink)
    link._buf = bytearray()
    link.on_scan = lambda s, o, r: got.append((s, struct.pack("<ff", *o),
                                               r))
    load = native.wire_native
    if not use_native:
        native.wire_native = lambda: None
    try:
        for a, b in zip((0, *cuts), (*cuts, len(stream))):
            link._buf.extend(stream[a:b])
            link._drain()
    finally:
        native.wire_native = load
    return got, bytes(link._buf)


def check_native_build(torch, log):
    """The g++ build of ``slamrs_tpu_torch/native``; the native Neato
    parser bitwise the python path on ``log``, the native wire codec
    bitwise the python drain on a 200-message stream cut at random
    offsets."""
    import numpy as np

    from slamrs_tpu_torch import native
    from slamrs_tpu_torch.io import neato

    t0 = time.perf_counter()
    native.build(force=True)
    seconds = time.perf_counter() - t0
    parser, wire = native.neato_native(), native.wire_native()
    if parser is None or wire is None:
        raise AssertionError(f"native library did not build: "
                             f"{native.build_error}")
    nat, py = parser.parse_packets(log), neato._parse_packets_py(log)
    frames_equal = len(nat) == len(py) and all(
        np.array_equal(getattr(a, k), getattr(b, k))
        and getattr(a, k).dtype == getattr(b, k).dtype
        for a, b in zip(nat, py) for k in ("distance", "strength", "valid"))
    stream = wire_stream(0)
    rng = np.random.default_rng(1)
    cuts = sorted(rng.choice(len(stream), 40, replace=False).tolist())
    wire_nat = drain_stream(stream, cuts, True)
    wire_py = drain_stream(stream, cuts, False)
    emit({"phase": "native_build", "seconds": seconds,
          "library": str(native.LIB.relative_to(Path(__file__)
                                                .resolve().parent)),
          "log_frames": len(nat), "parser_equal": frames_equal,
          "wire_frames": len(wire_nat[0]), "wire_equal": wire_nat == wire_py})
    if not frames_equal or wire_nat != wire_py or len(wire_nat[0]) < 100:
        raise AssertionError("native robot I/O differs from the python path")


def check_virtual_robot_card_vs_cpu(card, cpu):
    """The same command script on a card robot and a CPU robot: the same
    message count and kinds, odometry and rpm bitwise, valid masks equal,
    distances within 1 mm on fewer than 1e-3 of the valid beams."""
    import numpy as np

    from slamrs_tpu_torch.io.neato import parse_frame

    (card_out, card_truth, card_s), (cpu_out, cpu_truth, cpu_s) = card, cpu
    kinds_equal = [m[:1] for m in card_out] == [m[:1] for m in cpu_out]
    fa, fb = scan_frames(card_out), scan_frames(cpu_out)
    odo_equal = [(f.odometry, f.rpm) for f in fa] == [(f.odometry, f.rpm)
                                                      for f in fb]
    valid_equal, beams, off, worst = True, 0, 0, 0
    for a, b in zip(fa, fb):
        pa, pb = parse_frame(a.scan_data), parse_frame(b.scan_data)
        valid_equal &= bool(np.array_equal(pa.valid, pb.valid))
        v = pa.valid != 0
        d = np.abs(pa.distance.astype(int) - pb.distance.astype(int))[v]
        beams += int(v.sum())
        off += int((d > 0).sum())
        worst = max(worst, int(d.max(initial=0)))
    emit({"phase": "virtual_robot_card_vs_cpu", "messages": len(card_out),
          "scan_frames": len(fa), "valid_beams": beams,
          "beams_off_by_1mm": off, "max_mm": worst,
          "odometry_rpm_bitwise": odo_equal, "valid_equal": valid_equal,
          "truth_equal": bool(np.array_equal(card_truth, cpu_truth)),
          "card_seconds": card_s, "cpu_seconds": cpu_s})
    if not (kinds_equal and len(card_out) == len(cpu_out) and odo_equal
            and valid_equal and worst <= 1 and off < 1e-3 * beams
            and len(fa) == int(round(ROBOT_SECONDS / 0.2))):
        raise AssertionError("virtual robot on the card differs from the "
                             "CPU beyond the 1 mm gate")


def check_replay_log(log_path, revs):
    """``python -m slamrs_tpu_torch replay`` on the card robot's log: one
    frame fewer than the revolutions written (the last is not closed)."""
    root = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-m", "slamrs_tpu_torch",
                           "replay", str(log_path)], cwd=root,
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"replay exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    emit({"phase": "replay_log", "revolutions": revs, **report,
          "bytes": log_path.stat().st_size})
    if report["frames"] != revs - 1:
        raise AssertionError(f"replay gave {report['frames']} frames of "
                             f"{revs} revolutions")


def replay_yaml(log_path) -> str:
    root = Path(__file__).resolve().parent
    text = (root / "configs" / "neato_replay.yaml").read_text()
    if "path: null" not in text:
        raise AssertionError("neato_replay.yaml has no `path: null`")
    return text.replace("path: null", f"path: {log_path}")


def in_first_frame(truth):
    """True poses relative to the first, in its frame (x, y)."""
    import numpy as np

    x0, y0, t0 = truth[0]
    c, s = np.cos(-t0), np.sin(-t0)
    dx, dy = truth[:, 0] - x0, truth[:, 1] - y0
    return np.stack([c * dx - s * dy, s * dx + c * dy], axis=1)


def run_replay(torch, text, device):
    """The replay App on ``device`` until the FileLoader is done and its
    last scan is mapped, the counts set to 0 just before and read just
    after.  Returns the node, counts, seconds, frames, poses."""
    import numpy as np

    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.graph.nodes.robot import FileLoaderNode
    from slamrs_tpu_torch.graph.nodes.slam import IcpPointMapperNode

    app = App.from_yaml(text, device=device)
    loader, node = app.node(FileLoaderNode), app.node(IcpPointMapperNode)
    poses = app.pubsub.subscribe("robot/pose")
    frames = 0
    reset_counts()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not loader.done:
        app.frame()
        frames += 1
    app.run(frames=2)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    return node, counts, seconds, frames + 2, np.array(
        [m.pose for m in poses.drain()])


def check_app_neato_replay(torch, log_path, truth):
    """``configs/neato_replay.yaml`` with ``path`` set through the App on
    the card: one ICP update a frame of the log, K4 ten times an update
    and no other kernel, the ICP pose within 0.01 m RMSE of the robot's
    true pose in the first scan's frame, and its position within 2e-3 m
    of the same replay on the CPU at every update (the heading difference
    is reported: where the ICP solve fails on both, as it does on a few
    updates of this log in both packages, it is amplified)."""
    import numpy as np

    from slamrs_tpu_torch.io.neato import load_neato_binary

    text = replay_yaml(log_path)
    n_frames = len(load_neato_binary(log_path))
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    node, counts, seconds, frames, est = run_replay(torch, text, "cuda")
    peak = torch.cuda.max_memory_allocated() - held
    _, _, cpu_s, _, cpu_est = run_replay(torch, text, "cpu")
    err = est[:, :2] - in_first_frame(truth[:len(est)])
    rmse = float(np.sqrt((err ** 2).mean()))
    off = np.sqrt((err ** 2).sum(axis=1))
    if est.shape != cpu_est.shape:
        raise AssertionError(f"replay: {len(est)} poses on the card, "
                             f"{len(cpu_est)} on the CPU")
    # the gate is on position (m); theta (rad) is reported beside it
    gap_xy = np.abs(est[:, :2] - cpu_est[:, :2]).max(axis=1)
    gap_theta = np.abs(est[:, 2] - cpu_est[:, 2])
    worst = np.argsort(gap_xy)[::-1][:5]
    gap = float(gap_xy.max())
    iters = node.map_cfg.iterations
    emit({"phase": "app_neato_replay", "log_frames": n_frames,
          "app_frames": frames, "updates": node.updates,
          "launch_counts": counts,
          "k4_launches_per_frame": counts["nn_argmin"] / frames,
          "map_count": int(node.state.count),
          "icp_pose_rmse_xy_m": rmse,
          "icp_pose_max_err_m": float(off.max()),
          "updates_off_by_over_1cm": np.flatnonzero(off > 0.01).tolist(),
          "card_vs_cpu_max_xy_diff_m": gap,
          "card_vs_cpu_worst_updates": worst.tolist(),
          "card_vs_cpu_worst_xy_diff_m": gap_xy[worst].tolist(),
          "card_vs_cpu_max_theta_diff_rad": float(gap_theta.max()),
          "card_vs_cpu_theta_argmax": int(gap_theta.argmax()),
          "seconds": seconds,
          "frames_per_s": frames / seconds, "cpu_seconds": cpu_s,
          "peak_above_held_bytes": peak})
    want = {"fused_update": 0, "fused_update_in_place": 0, "cow_copy": 0,
            "fused_update_tiled": 0, "nn_argmin": iters * n_frames,
            "icp_solve": (iters + 1) * n_frames, "sim_frame": 0}
    if node.updates != n_frames or len(est) != n_frames or counts != want:
        raise AssertionError(f"replay: {node.updates} updates of "
                             f"{n_frames} frames, launches {counts}")
    if not rmse <= REPLAY_ICP_RMSE_GATE_M or not gap <= ICP_CPU_GATE_M:
        raise AssertionError(f"replay ICP RMSE {rmse} m, card vs CPU {gap}")
    return counts


def check_file_loader_no_host_sync(torch, log_path):
    """30 frames of a graph holding only the ``!FileLoader``, on the card,
    under ``torch.cuda.set_sync_debug_mode("error")``."""
    from slamrs_tpu_torch.graph.app import App

    app = App.from_yaml("nodes:\n- !FileLoader\n  topic_observation: obs\n"
                        f"  topic_pose: pose\n  path: {log_path}\n",
                        device="cuda")
    obs = app.pubsub.subscribe("obs")
    app.frame()  # warm: the first pinned block, the device constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(30):
            app.frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    scans = obs.drain()
    on_card = all(t.is_cuda for s in scans for t in s)
    emit({"phase": "file_loader_no_host_sync", "frames": 30,
          "scans": len(scans), "on_card": on_card})
    if len(scans) != 31 or not on_card:
        raise AssertionError(f"file loader published {len(scans)} scans")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_robot_link_card(torch):
    """``python -m slamrs_tpu_torch robot`` in its own process (its lidar
    on the card) and ``configs/neato_grid_slam.yaml`` at full size on the
    card, connected over TCP, driven forward through ``!Controls``: at
    least 20 ScanOdometry messages and 20 dda updates in at most 60 s,
    never more updates than messages, no kernel, finite poses that move
    more than 0.05 m; ``terminate()`` returns and the robot process ends
    at ctrl-C with exit code 0."""
    import select
    import signal

    import numpy as np

    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.graph.nodes.robot import RobotConnectionNode
    from slamrs_tpu_torch.graph.nodes.slam import GridMapSlamNode
    from slamrs_tpu_torch.graph.nodes.util import ControlsNode

    root = Path(__file__).resolve().parent
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "slamrs_tpu_torch", "robot", "--host",
         "127.0.0.1", "--port", str(port)], cwd=root,
        stderr=subprocess.PIPE, text=True)
    ended = None
    try:
        t0 = time.perf_counter()
        lines = []
        while not (lines and "listening" in lines[-1]):
            left = 120 - (time.perf_counter() - t0)
            ready = select.select([proc.stderr], [], [], max(left, 0))[0]
            if not ready or proc.poll() is not None:
                raise AssertionError(f"robot did not start: {lines}")
            lines.append(proc.stderr.readline())
        start_s = time.perf_counter() - t0
        text = (root / "configs" / "neato_grid_slam.yaml").read_text()
        text = text.replace('host: "robot"', 'host: "127.0.0.1"').replace(
            "port: 8080", f"port: {port}")
        app = App.from_yaml(text, device="cuda")
        link = app.node(RobotConnectionNode)
        slam = app.node(GridMapSlamNode)
        poses = app.pubsub.subscribe("robot/pose")
        scans = app.pubsub.subscribe("robot/observation_odometry")
        received = 0
        reset_counts()
        with SpanTimes("GridMapSlam::update") as spans:
            link.connect()
            app.node(ControlsNode).set_command(0.1, 0.1)
            t0 = time.perf_counter()
            while (time.perf_counter() - t0 < LINK_WALL_S
                   and min(received, slam.updates) < LINK_MIN_MESSAGES):
                app.frame()
                received += len(scans.drain())
                time.sleep(1 / 30)
            seconds = time.perf_counter() - t0
            state = link.state
            t1 = time.perf_counter()
            app.terminate()
            terminate_s = time.perf_counter() - t1
        counts = read_counts()
        est = np.array([m.pose for m in poses.drain()])
        proc.send_signal(signal.SIGINT)
        ended = proc.wait(timeout=30)
        robot_log = lines + proc.stderr.read().splitlines()[-8:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    moved = float(np.hypot(*(est[-1, :2] - est[0, :2]))) if len(est) else 0.0
    emit({"phase": "robot_link_card", "robot_start_s": start_s,
          "messages": received, "updates": slam.updates,
          "seconds": seconds, "messages_per_s": received / seconds,
          "state_while_streaming": state, "launch_counts": counts,
          "update_span_median_ms": statistics.median(spans.ms)
          if spans.ms else None, "moved_m": moved,
          "final_pose": est[-1].tolist() if len(est) else None,
          "terminate_s": terminate_s, "link_state_after": link.state,
          "robot_exit_code": ended, "robot_stderr": robot_log})
    if (received < LINK_MIN_MESSAGES or slam.updates < LINK_MIN_MESSAGES
            or slam.updates > received or any(counts.values())
            or not np.isfinite(est).all() or not moved > 0.05
            or state != "running" or link.state != "idle"
            or ended != 0):
        raise AssertionError("robot_link_card failed its gates")


# --- the captured rollout: one CUDA graph replay a frame ---------------

# the kernels by the names the profiler shows, and their wrapper counters.
# Not the simulator kernel: it is the first launch of every frame, and a
# profile that opens at a frame drops the launches made as it starts (on
# an 8-row mesh: 8 of 16 seen eager, 72 of 80 over 10 replays); the
# benchmark's traced runs count it (sim_launches_per_frame)
PROFILED_KERNELS = {"fused_update": "fused_update_kernel",
                    "cow_copy": "cow_copy_kernel",
                    "fused_update_tiled": "fused_update_tiled_kernel",
                    "nn_argmin": "nn_argmin_kernel",
                    "icp_solve": "icp_solve_kernel"}
# runtime calls by which the host puts work on the card
HOST_LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset")


def capture_routes(torch):
    """(label, world, worlds, ticks, kernel launches a frame) of every
    route the captured rollout covers."""
    k1 = {"fused_update": 1, "fused_update_in_place": 0,
          "fused_update_tiled": 0, "cow_copy": 0, "nn_argmin": 0}
    in_place = dict(k1, fused_update_in_place=1)
    return [
        ("headline_0.05m", lambda: headline_world(torch, 0.05), (), 300, k1),
        ("headline_0.02m", lambda: headline_world(torch, 0.02), (), 150, k1),
        ("config3_tiled", lambda: config3_world(torch), (), 300,
         dict(k1, fused_update=0, fused_update_tiled=1)),
        ("config3_cow", lambda: config3_world(torch, resample_cow=True), (),
         300, dict(in_place, cow_copy=1)),
        ("gather_0.05m", lambda: with_grid(
            headline_world(torch, 0.05), resample_cow=False,
            fused_resident=False), (), 300, in_place),
        ("dda_grid_slam_yaml", lambda: preset_world(torch, "grid_slam.yaml"),
         (), 300, NO_KERNELS),
        ("dense_grid_slam_yaml", lambda: with_grid(
            preset_world(torch, "grid_slam.yaml"), integrate="dense"), (),
         300, NO_KERNELS),
        ("dda_0.05m", lambda: headline_world(torch, 0.05, "dda", "float32"),
         (), 300, NO_KERNELS),
        ("icp_test_yaml", lambda: preset_world(torch, "icp_test.yaml"), (),
         300, dict(NO_KERNELS, nn_argmin=10, icp_solve=11)),
        ("landmarks_yaml", lambda: preset_world(torch, "landmarks.yaml"), (),
         300, NO_KERNELS),
        ("fleet_256x10_0.02m", lambda: fleet_world(torch), (FLEET_WORLDS,),
         300, dict(in_place, cow_copy=1)),
    ]


def capture_draws(fw, worlds, n_steps, seed):
    """Injected draws for every frame: the grid's (numpy) and, for a world
    with the EKF, the landmark sensor's."""
    import numpy as np

    kw = {}
    if fw.grid_config is not None:
        kw["noise"] = injected_grid_noise(fw, n_steps, seed, worlds)
    if fw.ekf_config is not None:
        frames = fw.fire_schedule(n_steps, 0.0)[0].size
        lanes = fw.scene.landmarks.shape[0]
        rng = np.random.default_rng(seed + 1)
        kw["landmark_noise"] = tuple(
            rng.standard_normal((frames, *worlds, lanes)).astype(np.float32)
            for _ in range(2))
    return kw


def capture_run(torch, fw, worlds, n_steps, capture, profiled=False,
                method="rollout_cadence", **kw):
    """One ``rollout_cadence`` (or ``method``) from a fresh state (placed
    on ``fw.mesh`` first when it has one), the counts set to 0 just
    before and read just after.  Returns a dict: state (whole), outs,
    counts, seconds, the run's own peak memory, and with ``profiled`` the
    device busy time, the host's launch calls and the kernels by name."""
    from slamrs_tpu_torch.parallel import fleet

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = fw.init(worlds)
    if fw.mesh is not None:
        state = fleet.shard_world_state(state, fw.mesh, worlds[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = started_profile(torch) if profiled else None
    reset_counts()
    t0 = time.perf_counter()
    state, outs = getattr(fw, method)(state, n_steps, seed=0,
                                      capture=capture, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    if prof is not None:
        prof.stop()
    if fw.mesh is not None:
        require(fleet.mesh_of(state) == fw.mesh,
                "a mesh world's rollout left its mesh")
        state = fleet.unshard_world_state(state)
    run = {"state": state, "outs": outs, "counts": counts,
           "seconds": seconds,
           "peak": torch.cuda.max_memory_allocated() - base}
    if profiled:
        run.update(profile_summary(prof, seconds))
    return run


def started_profile(torch):
    """A CPU and CUDA ``torch.profiler`` profile, started and past a
    warm-up step whose events are dropped; ``stop()`` ends it.  A profile
    loses launches made as it starts: the first kernels of a frame
    (an ICP frame's simulator kernel, then up to its first K4 and solve
    launches: 99 of 100 K4 kernels seen over 10 eager frames), so the
    warm-up spins the card and runs a few tiny kernels first."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1))
    prof.start()
    torch.cuda._sleep(2_000_000)
    for _ in range(8):
        torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    prof.step()
    return prof


def profile_summary(prof, seconds) -> dict:
    """Device busy time, idle share over ``seconds`` of wall time, the
    host's launch calls and the kernels by name, of a profile."""
    events = prof.key_averages()
    device = [e for e in events if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    return dict(
        busy=busy, idle=1 - busy / seconds,
        host_calls=sum(e.count for e in events
                       if e.device_type.name == "CPU"
                       and e.key.startswith("cu")
                       and any(c in e.key for c in HOST_LAUNCH_CALLS)),
        by_name={name: sum(e.count for e in device if kern in e.key)
                 for name, kern in PROFILED_KERNELS.items()})


class ProfiledReplays:
    """Profiles ``n`` calls of a program's ``method`` (``FrameProgram.
    frame``, ``FrameProgram.tick``) after its first ``skip``: replays once
    the graphs are captured.  After the run: the profile's summary over
    the window's wall time, the wrappers' launches in the window
    (``counts``) and the graph replays it held (``replays``)."""

    def __init__(self, torch, cls, method, skip, n):
        self.torch, self.cls, self.method = torch, cls, method
        self.skip, self.n, self.seen = skip, n, 0
        self.summary = None

    def __enter__(self):
        orig = self.orig = getattr(self.cls, self.method)
        outer, torch = self, self.torch

        def call(prog, *args, **kw):
            i = outer.seen
            outer.seen += 1
            if i == outer.skip:
                torch.cuda.synchronize()
                outer.prof = started_profile(torch)
                outer.before = (read_counts(), prog.stats.replays)
                outer.t0 = time.perf_counter()
            out = orig(prog, *args, **kw)
            if i == outer.skip + outer.n - 1:
                torch.cuda.synchronize()
                seconds = time.perf_counter() - outer.t0
                outer.prof.stop()
                after = read_counts()
                outer.counts = {k: after[k] - outer.before[0][k]
                                for k in after}
                outer.replays = prog.stats.replays - outer.before[1]
                outer.summary = profile_summary(outer.prof, seconds)
                outer.summary["seconds"] = seconds
            return out

        setattr(self.cls, self.method, call)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.orig)
        if exc[0] is None:
            require(self.summary is not None, "the profiled window did "
                    "not close")
        return False


def check_capture(torch, label, make, worlds, n_steps, per_frame):
    """The captured rollout against the eager loop on one route: bitwise
    under injected draws and under the seed; launches a frame from the
    wrappers' counters and the profiler's kernel names; host launch calls
    a frame, idle share, ticks/s and each run's own peak memory beside
    the eager run's.  Returns the captured run's counts."""
    import dataclasses

    t0 = time.perf_counter()
    fw = make()
    kw = capture_draws(fw, worlds, n_steps, 11)
    runs = {}
    for capture in (False, True):  # injected draws
        runs[capture] = capture_run(torch, fw, worlds, n_steps, capture, **kw)
    same_injected = (same_state(torch, runs[False]["state"],
                                runs[True]["state"])
                     and same_state(torch, runs[False]["outs"],
                                    runs[True]["outs"]))
    runs.clear()
    for capture in (False, True):  # the seed, timed
        runs[capture] = capture_run(torch, fw, worlds, n_steps, capture)
    stats = dataclasses.replace(fw.capture_stats)
    same_seed = (same_state(torch, runs[False]["state"], runs[True]["state"])
                 and same_state(torch, runs[False]["outs"],
                                runs[True]["outs"]))
    frames = int(runs[True]["outs"].fired.shape[0])
    eager_counts, counts = runs[False]["counts"], runs[True]["counts"]
    timed = {c: (runs[c]["seconds"], runs[c]["peak"]) for c in runs}
    runs.clear()
    # the eager loop is the same every frame: its profile covers its
    # first 10 frames (the profiler's own cost grows with the launches)
    fires = fw.fire_schedule(n_steps, 0.0)[0]
    eager_ticks = int(fires[min(9, fires.size - 1)]) + 1
    prof = {c: capture_run(torch, fw, worlds,
                           n_steps if c else eager_ticks, c, profiled=True)
            for c in (False, True)}
    prof_frames = {c: int(prof[c]["outs"].fired.shape[0]) for c in prof}
    n_worlds = worlds[0] if worlds else 1
    # a fresh program's runs: the frames, then the trailing idle ticks' one
    trailing = int(fires[-1] < n_steps - 1)
    emit({"phase": f"capture_{label}", "ticks": n_steps, "worlds": n_worlds,
          "frames": frames, "graphs": stats.graphs,
          "idle_counts": sorted(k for k in stats.launches
                                if isinstance(k, int)),
          "eager_frames": stats.eager - trailing, "replays": stats.replays,
          "capture_s": stats.capture_seconds,
          "bitwise_injected": same_injected, "bitwise_seed": same_seed,
          "launch_counts": counts, "eager_launch_counts": eager_counts,
          "profiled_kernels": prof[True]["by_name"],
          "eager_profiled_kernels": prof[False]["by_name"],
          "host_launch_calls_per_frame": {
              c: prof[b]["host_calls"] / prof_frames[b]
              for c, b in (("eager", False), ("captured", True))},
          "profiled_ticks": {"eager": eager_ticks, "captured": n_steps},
          "copy_back_bytes_per_frame": {str(k): v for k, v in
                                        stats.copy_back_bytes.items()},
          "ticks_per_s": {"eager": n_steps / timed[False][0],
                          "captured": n_steps / timed[True][0]},
          "world_ticks_per_s": {"eager": n_worlds * n_steps / timed[False][0],
                                "captured":
                                n_worlds * n_steps / timed[True][0]},
          "device_busy_s": {"eager": prof[False]["busy"],
                            "captured": prof[True]["busy"]},
          "idle_share": {"eager": prof[False]["idle"],
                         "captured": prof[True]["idle"]},
          "wall_s_profiled": {"eager": prof[False]["seconds"],
                              "captured": prof[True]["seconds"]},
          "peak_memory_bytes": {"eager": timed[False][1],
                                "captured": timed[True][1]},
          "seconds": time.perf_counter() - t0})
    require(same_injected and same_seed,
            f"capture {label}: the captured run differs from the eager loop")
    require(counts == eager_counts,
            f"capture {label}: launches {counts} != eager {eager_counts}")
    require(counts["sim_frame"] == frames + trailing,
            f"capture {label}: {counts['sim_frame']} sim_frame launches, "
            f"expected one a frame and one for the trailing idle ticks")
    require(stats.graphs >= 1 and stats.replays >= 1,
            f"capture {label}: no graph was replayed")
    for name, n in per_frame.items():
        want = n * frames
        require(counts[name] == want,
                f"capture {label}: {counts[name]} {name} launches, "
                f"expected {want}")
        if name in PROFILED_KERNELS:
            for c in (False, True):
                want = counts[name] * prof_frames[c] // frames
                require(prof[c]["by_name"][name] == want,
                        f"capture {label}: the profiler saw "
                        f"{prof[c]['by_name'][name]} {name} kernels "
                        f"(captured={c}), expected {want}")
    require(prof[True]["busy"] > 0, f"capture {label}: no device events")
    return counts


def check_captures(torch):
    """Every captured route; returns each route's captured launch counts."""
    t0 = time.perf_counter()
    counts = {label: check_capture(torch, label, make, worlds, n, per_frame)
              for label, make, worlds, n, per_frame in capture_routes(torch)}
    emit({"phase": "capture_phases_time", "seconds": time.perf_counter() - t0})
    return counts


# the host graph's node programs against the op-by-op nodes: (label,
# preset, frames, warm frames before the profile, profiled frames,
# kernel launches an update of the SLAM node).  A profiled window holds
# 10-15 SLAM updates: over 65 replay updates (~1,100 graph nodes each)
# the profiler missed some K4 kernels in some windows while the counters
# held every launch; the 10-update windows missed none
APP_CAPTURES = [
    ("grid_slam_fused", "grid_slam_fused.yaml", 300, 30, 60,
     {"fused_update": 1}),
    ("icp_test", "icp_test.yaml", 900, 30, 60,
     {"nn_argmin": 10, "icp_solve": 11}),
    ("grid_slam_yaml", "grid_slam.yaml", 300, 60, 120, {}),
    ("landmarks", "landmarks.yaml", 300, 30, 60, {}),
]
APP_TOPICS = ("robot/pose", "slam/pose", "slam/map",
              "robot/observation_odometry", "robot/observation")


def app_values(torch, msg) -> list:
    """Every array a message carries, on the host."""
    import dataclasses

    import numpy as np

    if dataclasses.is_dataclass(msg):
        msg = tuple(getattr(msg, f.name) for f in dataclasses.fields(msg))
    if isinstance(msg, tuple):
        return [v for x in msg for v in app_values(torch, x)]
    if isinstance(msg, torch.Tensor):
        return [msg.cpu().numpy()]
    if isinstance(msg, (bool, int, float)):
        return [np.asarray(msg)]
    return [np.asarray(getattr(msg, a)) for a in
            ("pose", "position", "data", "points", "means", "covariances",
             "seen") if hasattr(type(msg), a)]


def app_slam_node(app):
    from slamrs_tpu_torch.graph.nodes import slam

    return next(n for n in app.nodes
                if isinstance(n, (slam.GridMapSlamNode,
                                  slam.IcpPointMapperNode,
                                  slam.EKFLandmarkSlamNode)))


def app_frames(app, frames):
    """``frames`` frames; None: until the FileLoader is done, and two more
    (the last scan mapped).  Returns the frames run."""
    from slamrs_tpu_torch.graph.nodes.robot import FileLoaderNode

    if frames is not None:
        app.run(frames=frames)
        return frames
    loader, n = app.node(FileLoaderNode), 2
    while not loader.done:
        app.frame()
        n += 1
    app.run(frames=2)
    return n


def app_capture_run(torch, text, frames, capture, draws=None):
    """A fresh App on the card, captured or op by op, for ``frames``
    frames, the counts set to 0 just before and read just after;
    ``draws`` (device tensors, an update or a tick a row) replace the
    grid node's and the landmark sensor's draws."""
    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.graph.nodes.sim import SimulatorNode
    from slamrs_tpu_torch.graph.nodes.slam import GridMapSlamNode
    from slamrs_tpu_torch.models.gridslam import UpdateNoise

    app = App.from_yaml(text, device="cuda", capture=capture)
    if draws is not None:
        grid, sim = app.node(GridMapSlamNode), app.node(SimulatorNode)
        if grid is not None:
            grid.noise_for_update = lambda i: UpdateNoise(
                *(x[i] for x in draws["grid"]))
        if sim is not None:
            sim.landmark_noise = lambda i: tuple(x[i]
                                                 for x in draws["landmarks"])
    subs = {t: app.pubsub.subscribe(t) for t in APP_TOPICS}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    n = app_frames(app, frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"app": app, "counts": read_counts(), "seconds": seconds,
            "frames": n, "updates": app_slam_node(app).updates,
            "msgs": {t: [app_values(torch, m) for m in s.drain()]
                     for t, s in subs.items()}}


def same_app_run(torch, a, b) -> bool:
    """Every message, every node state and the launch counts bitwise."""
    import numpy as np

    from slamrs_tpu_torch.graph.capture import _tensor_leaves

    if a["counts"] != b["counts"] or a["frames"] != b["frames"]:
        return False
    for t in APP_TOPICS:
        ma, mb = a["msgs"][t], b["msgs"][t]
        if len(ma) != len(mb) or any(
                len(x) != len(y) or not all(
                    u.dtype == v.dtype and np.array_equal(u, v)
                    for u, v in zip(x, y)) for x, y in zip(ma, mb)):
            return False
    for na, nb in zip(a["app"].nodes, b["app"].nodes):
        if isinstance(getattr(na, "state", None), tuple) and not all(
                torch.equal(x, y) for x, y in
                zip(_tensor_leaves(na.state), _tensor_leaves(nb.state))):
            return False
    return True


def app_profile(torch, text, capture, warm, frames):
    """A profiled window of ``frames`` frames after ``warm`` frames of a
    fresh App: device busy time, idle
    share, the host's launch calls, the kernels by name, the SLAM
    node's updates in the window."""
    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.utils import trace

    app = App.from_yaml(text, device="cuda", capture=capture)
    app.run(frames=warm)
    node = app_slam_node(app)
    before = node.updates
    torch.cuda.synchronize()
    prof = started_profile(torch)
    t0 = time.perf_counter()
    n = app_frames(app, frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    spans = set(trace.all_stats())
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type.name == "CUDA" and e.key not in spans]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    return {"frames": n, "updates": node.updates - before, "wall": wall,
            "busy": busy, "idle": 1 - busy / wall,
            "host_calls": sum(e.count for e in events
                              if e.device_type.name == "CPU"
                              and e.key.startswith("cu")
                              and any(c in e.key for c in HOST_LAUNCH_CALLS)),
            "by_name": {name: sum(e.count for e in device if kern in e.key)
                        for name, kern in PROFILED_KERNELS.items()}}


def graph_label(key) -> str:
    """A node program's graph key as text: the simulator's ``idle`` or
    ``fire``, grid SLAM's ``update`` or ``map``."""
    kind = key[0]
    if isinstance(kind, tuple):  # the simulator's (fired, dt, params)
        return "fire" if kind[0] else "idle"
    return str(kind)


def app_draws(torch, text, frames, seed):
    """Numpy draws for every grid update and every simulator tick of an
    App run, on the card."""
    import numpy as np

    from slamrs_tpu_torch.graph.config import parse_config
    from slamrs_tpu_torch.graph.nodes.sim import SimulatorNodeConfig
    from slamrs_tpu_torch.graph.nodes.slam import GridMapSlamNodeConfig

    rng = np.random.default_rng(seed)
    cfg = parse_config(text)
    draws = {"grid": None, "landmarks": None}
    for _, node in cfg.nodes:
        if isinstance(node, GridMapSlamNodeConfig):
            p = node.slam_config().n_particles
            draws["grid"] = (rng.standard_normal((frames, p), np.float32),
                             rng.standard_normal((frames, p), np.float32),
                             rng.random((frames, 1), np.float32))
        if isinstance(node, SimulatorNodeConfig):
            lanes = max(len(node.landmarks), 1)
            draws["landmarks"] = tuple(
                rng.standard_normal((frames + 2, lanes), np.float32)
                for _ in range(2))
    return {k: None if v is None else tuple(
        torch.from_numpy(x).to("cuda") for x in v) for k, v in draws.items()}


def check_app_capture(torch, label, text, frames, warm, profiled,
                      per_update):
    """The App's node programs as CUDA graphs (``App(capture=True)``)
    against the op-by-op App (``capture=False``) on one preset: every
    message, node state and launch count bitwise under injected draws and
    under the seed; K1/K4 an update by counter and by the profiler's
    kernel names, no other kernel; every programmed node replaying.
    Printed beside the op-by-op run's: frames/s, host launch calls a
    frame, device busy time and idle share over a profiled window after
    ``warm`` frames, and per node the graphs, replays, capture seconds,
    launches a replay and bytes copied back a replay."""
    t0 = time.perf_counter()
    draws = app_draws(torch, text, 1000 if frames is None else frames, 13)
    same = {}
    for kind, kw in (("injected", {"draws": draws}), ("seed", {})):
        runs = {c: app_capture_run(torch, text, frames, c, **kw)
                for c in (False, True)}
        same[kind] = same_app_run(torch, runs[False], runs[True])
    eager, captured = runs[False], runs[True]
    stats = captured["app"].program_stats()
    updates, n = captured["updates"], captured["frames"]
    counts = captured["counts"]
    del runs, eager["app"]
    prof = {c: app_profile(torch, text, c, warm, profiled)
            for c in (False, True)}
    emit({"phase": f"app_capture_{label}", "frames": n, "updates": updates,
          "bitwise_injected": same["injected"], "bitwise_seed": same["seed"],
          "launch_counts": counts, "eager_launch_counts": eager["counts"],
          "frames_per_s": {"eager": n / eager["seconds"],
                           "captured": n / captured["seconds"]},
          "profiled_frames": {c: prof[b]["frames"] for c, b in
                              (("eager", False), ("captured", True))},
          "profiled_kernels": {c: prof[b]["by_name"] for c, b in
                               (("eager", False), ("captured", True))},
          "host_launch_calls_per_frame": {
              c: prof[b]["host_calls"] / prof[b]["frames"]
              for c, b in (("eager", False), ("captured", True))},
          "device_busy_s": {"eager": prof[False]["busy"],
                            "captured": prof[True]["busy"]},
          "idle_share": {"eager": prof[False]["idle"],
                         "captured": prof[True]["idle"]},
          "wall_s_profiled": {"eager": prof[False]["wall"],
                              "captured": prof[True]["wall"]},
          "nodes": {node: {
              "eager": s.eager, "replays": s.replays, "graphs": s.graphs,
              "capture_s": s.capture_seconds,
              "launches_per_replay": {graph_label(k): v for k, v in
                                      s.launches.items() if any(v.values())},
              "copy_back_bytes_per_replay": {graph_label(k): v for k, v in
                                             s.copy_back_bytes.items()}}
              for node, s in stats.items()},
          "seconds": time.perf_counter() - t0})
    require(same["injected"] and same["seed"],
            f"app capture {label}: the captured App differs from op by op")
    for name in PROFILED_KERNELS:
        want = per_update.get(name, 0)
        require(counts[name] == want * updates,
                f"app capture {label}: {counts[name]} {name} launches over "
                f"{updates} updates")
        for c in (False, True):
            got = prof[c]["by_name"][name]
            require(got == want * prof[c]["updates"],
                    f"app capture {label}: the profiler saw {got} {name} "
                    f"kernels over {prof[c]['updates']} updates "
                    f"(captured={c})")
    require(counts["fused_update_in_place"] == 0,
            f"app capture {label}: K1 ran in place")
    for node, s in stats.items():
        require(s.graphs >= 1 and s.replays >= 1 and s.eager == s.graphs,
                f"app capture {label}: {node} {s}")
    require(prof[True]["busy"] > 0, f"app capture {label}: no device events")
    return counts


def check_app_captures(torch, log_path):
    """Every preset and the replay; returns each one's captured counts."""
    t0 = time.perf_counter()
    counts = {label: check_app_capture(
        torch, label, (Path(__file__).resolve().parent / "configs"
                       / preset).read_text(), frames, warm, profiled,
        per_update)
        for label, preset, frames, warm, profiled, per_update
        in APP_CAPTURES}
    counts["neato_replay"] = check_app_capture(
        torch, "neato_replay", replay_yaml(log_path), None, 10, 15,
        {"nn_argmin": 10, "icp_solve": 11})
    emit({"phase": "app_capture_phases_time",
          "seconds": time.perf_counter() - t0})
    return counts


def check_longrun(torch):
    """``tests/torch_longrun.py`` on the card: 500 grid-SLAM updates for
    dda (f32) and fused (bf16) through the grid node's update program,
    captured, under the JAX package's seed-7 draws; the JAX test's four
    gates, the numbers beside the JAX run's on the CPU; K1 once per fused
    update; each node: its update and its map eager once, 499 update
    replays."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_longrun

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    numbers, nodes = torch_longrun.run("cuda", graphs=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    stats = {k: n.program.stats for k, n in nodes.items()}
    emit({"phase": "longrun_fused_vs_dda_500", **numbers,
          "jax_cpu": torch_longrun.JAX_CPU, "gates": torch_longrun.GATES,
          "launch_counts": counts, "seconds": seconds,
          "nodes": {k: {"eager": s.eager, "replays": s.replays,
                        "graphs": s.graphs, "capture_s": s.capture_seconds,
                        "copy_back_bytes_per_replay": {
                            graph_label(g): v
                            for g, v in s.copy_back_bytes.items()}}
                    for k, s in stats.items()}})
    failed = torch_longrun.failed_gates(numbers)
    require(not failed, f"longrun: {failed} missed ({numbers})")
    require(counts == dict(NO_KERNELS, fused_update=torch_longrun.UPDATES,
                           fused_update_in_place=0, sim_frame=0),
            f"longrun launches {counts}")
    for k, s in stats.items():
        require((s.eager, s.replays, s.graphs)
                == (2, torch_longrun.UPDATES - 1, 2), f"longrun {k}: {s}")


# --- sharded frames and the tick rollout as CUDA graphs ------------------


def mesh_capture_routes(torch):
    """(label, world on its mesh, worlds, ticks, kernels a frame, at most
    a frame, local) of every mesh route the frame program covers; each
    mesh's entries are all the card."""
    def kernels(**kw):
        return dict(NO_KERNELS, **kw)

    def headline():
        return headline_world(torch, 0.05)

    return [
        ("config5_8x1", lambda: on_mesh(fleet_world(torch),
                                        cuda_mesh(torch, 1)),
         FLEET_WORLDS, 300, {"fused_update": 8, "fused_update_tiled": 0,
                             "nn_argmin": 0}, {"cow_copy": 8}, False),
        ("config5_4x2_local", lambda: on_mesh(fleet_world(torch),
                                              cuda_mesh(torch, 2)),
         FLEET_WORLDS, 300, kernels(fused_update=8), {}, True),
        ("headline_2x4_gather", lambda: on_mesh(
            with_grid(headline(), fleet_resample="gather"),
            cuda_mesh(torch, 4)), MESH_HEADLINE_WORLDS, 300,
         kernels(fused_update=8), {}, False),
        ("headline_2x4_local", lambda: on_mesh(headline(),
                                               cuda_mesh(torch, 4)),
         MESH_HEADLINE_WORLDS, 300, kernels(fused_update=8), {}, True),
        ("config3_tiled_2x1", lambda: on_mesh(config3_world(torch),
                                              cuda_mesh(torch, 1, n=2)),
         MESH_CONFIG3_WORLDS, MESH_CONFIG3_TICKS,
         kernels(fused_update_tiled=2), {}, False),
        ("grid_slam_yaml_4x2", lambda: on_mesh(
            preset_world(torch, "grid_slam.yaml"), cuda_mesh(torch, 2)), 16,
         300, kernels(), {}, False),
        ("icp_test_4x1", lambda: on_mesh(preset_world(torch, "icp_test.yaml"),
                                         cuda_mesh(torch, 1, n=4)),
         MESH_OTHER_WORLDS, 300, kernels(nn_argmin=40, icp_solve=44), {},
         False),
        ("landmarks_4x1", lambda: on_mesh(
            preset_world(torch, "landmarks.yaml"), cuda_mesh(torch, 1, n=4)),
         MESH_OTHER_WORLDS, 300, kernels(), {}, False),
    ]


def graph_key(key) -> str:
    return key if isinstance(key, str) else json.dumps(key)


def check_kernels_a_frame(label, counts, frames, exact, at_most):
    for name, n in exact.items():
        require(counts[name] == n * frames,
                f"{label}: {counts[name]} {name} launches, expected "
                f"{n * frames}")
    for name, n in at_most.items():
        require(counts[name] <= n * frames,
                f"{label}: {counts[name]} {name} launches, at most "
                f"{n * frames} expected")


def check_profiled(label, eager, window):
    """The profiler's kernel names count what the counters count, over
    the eager run's profile and the captured window; the device ran."""
    for name in PROFILED_KERNELS:
        for what, got, want in (("eager", eager["by_name"], eager["counts"]),
                                ("captured", window.summary["by_name"],
                                 window.counts)):
            require(got[name] == want[name],
                    f"{label}: the profiler saw {got[name]} {name} "
                    f"kernels ({what}), the counters {want[name]}")
    require(window.summary["busy"] > 0, f"{label}: no device events")


def profiled_pair(torch, fw, worlds, fires, method, eager_units, skip, n,
                  per_tick=False):
    """The eager loop profiled over its first ``eager_units`` frames (or
    ticks: it is the same every frame), and the captured run profiled
    over ``n`` replays after ``skip`` program calls.  Returns the eager
    run (with ``units``) and the window."""
    from slamrs_tpu_torch.graph import capture

    cls = capture.FrameProgram
    if per_tick:
        name, call = "tick", "rollout"
        eager_ticks, ticks = eager_units, skip + n + int(fires[0]) + 1
    else:
        name, call = "frame", method
        eager_ticks = int(fires[eager_units - 1]) + 1
        ticks = int(fires[skip + n]) + 1
    eager = capture_run(torch, fw, worlds, eager_ticks, False, profiled=True,
                        method=call)
    eager["units"] = eager_units
    with ProfiledReplays(torch, cls, name, skip, n) as window:
        capture_run(torch, fw, worlds, ticks, True, method=call)
    return eager, window


def check_mesh_capture(torch, label, make, worlds, n_steps, exact, at_most,
                       local):
    """The eager mesh rollout (``capture=False``) beside the captured one
    (``capture=None``, the default) on one route, fresh states, the same
    seed: bitwise state and outputs; K1-K4 a frame by counter, equal to
    the eager run's; a world-only, ``"gather"`` or dda mesh one graph a
    frame; ``"local"`` one overflow read a frame; then a profiled window
    of 10-15 frames each (host launch calls a frame, idle share, the
    profiler's kernel names).  Returns the captured run's counts."""
    import dataclasses

    t0 = time.perf_counter()
    fw = make()
    runs, reads = {}, {}
    for capture in (False, None):
        with OverflowReads(torch) as ov:
            runs[capture] = capture_run(torch, fw, (worlds,), n_steps,
                                        capture)
        reads[capture] = (ov.reads, ov.fallbacks)
    stats = dataclasses.replace(fw.capture_stats)
    same = (same_state(torch, runs[False]["state"], runs[None]["state"])
            and same_state(torch, runs[False]["outs"], runs[None]["outs"]))
    frames = int(runs[None]["outs"].fired.shape[0])
    counts, eager_counts = runs[None]["counts"], runs[False]["counts"]
    timed = {c: (runs[c]["seconds"], runs[c]["peak"]) for c in runs}
    runs.clear()
    # the eager loop over its first 2 frames; the captured run over 10
    # replayed frames after 3 program frames (first runs and captures)
    fires = fw.fire_schedule(n_steps, 0.0)[0]
    n = min(10, fires.size - 4)
    eager, window = profiled_pair(torch, fw, (worlds,), fires,
                                  "rollout_cadence", 2, 3, n)
    rate = {"eager": (eager, 2), "captured": (window.summary, n)}
    split = [k for k in stats.launches
             if isinstance(k, tuple) and k[1] in ("head", "tail", "row")]
    # a fresh program's runs: the frames, then the trailing idle ticks' one
    trailing = int(fires[-1] < n_steps - 1)
    emit({"phase": f"mesh_capture_{label}", "ticks": n_steps,
          "worlds": worlds, "mesh": fw.mesh.shape, "frames": frames,
          "bitwise": same, "launch_counts": counts,
          "eager_launch_counts": eager_counts,
          "kernels_per_frame": {k: v / frames for k, v in counts.items()},
          "graphs": stats.graphs, "graph_keys":
          sorted(graph_key(k) for k in stats.launches),
          "eager_frames": stats.eager - trailing, "replays": stats.replays,
          "capture_s": stats.capture_seconds,
          "copy_back_bytes_per_frame": {graph_key(k): v for k, v in
                                        stats.copy_back_bytes.items()},
          "overflow_reads_per_frame": {
              "eager": reads[False][0] / frames,
              "captured": reads[None][0] / frames},
          "overflow_fallbacks": {"eager": reads[False][1],
                                 "captured": reads[None][1]},
          "host_launch_calls_per_frame": {
              c: r["host_calls"] / k for c, (r, k) in rate.items()},
          "device_busy_ms_per_frame": {
              c: 1e3 * r["busy"] / k for c, (r, k) in rate.items()},
          "idle_share": {c: r["idle"] for c, (r, _) in rate.items()},
          "profiled_frames": {"eager": 2, "captured": n,
                              "captured_replays": window.replays},
          "profiled_kernels": {"eager": eager["by_name"],
                               "captured": window.summary["by_name"]},
          "window_world_ticks_per_s": worlds * (
              int(fires[3 + n]) - int(fires[3])) / window.summary["seconds"],
          "world_ticks_per_s": {"eager": worlds * n_steps / timed[False][0],
                                "captured":
                                worlds * n_steps / timed[None][0]},
          "peak_memory_bytes": {"eager": timed[False][1],
                                "captured": timed[None][1]},
          "seconds": time.perf_counter() - t0})
    require(same, f"mesh capture {label}: the captured run differs from "
            "the eager mesh loop")
    require(counts == eager_counts,
            f"mesh capture {label}: launches {counts} != eager "
            f"{eager_counts}")
    check_kernels_a_frame(f"mesh capture {label}", counts, frames, exact,
                          at_most)
    require(stats.replays >= 1 and stats.replays + stats.eager
            == frames + trailing, f"mesh capture {label}: frames not replayed")
    if local:
        require(reads[None][0] == frames == reads[False][0]
                and stats.overflow_reads == frames - 1 and split,
                f"mesh capture {label}: overflow reads {reads} in "
                f"{frames} frames")
    else:
        require(not split and reads[None][0] == 0,
                f"mesh capture {label}: not one graph a frame")
    check_profiled(f"mesh capture {label}", eager, window)
    return counts


class LastFrameUnderSyncError:
    """Runs the last frame of a captured rollout under
    ``set_sync_debug_mode("error")`` (the device synchronized just
    before); ``replayed`` says whether that frame was a replay."""

    def __init__(self, torch):
        self.torch, self.replayed = torch, None

    def __enter__(self):
        from slamrs_tpu_torch.graph import capture

        self.cls = capture.FrameProgram
        orig = self.orig = self.cls.frame
        outer, torch = self, self.torch

        def frame(prog, k, speeds, f):
            if f != prog.stats.frames - 1:
                return orig(prog, k, speeds, f)
            before = prog.stats.replays
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                orig(prog, k, speeds, f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outer.replayed = prog.stats.replays - before

        self.cls.frame = frame
        return self

    def __exit__(self, *exc):
        self.cls.frame = self.orig
        return False


def replay_ticks(fw, frames_min=4) -> int:
    """Ticks of a rollout whose last frame's idle count occurred before,
    after frame 0: that frame is a replay."""
    import numpy as np

    fires = fw.fire_schedule(2000, 0.0)[0]
    idle = list(np.diff(fires, prepend=-1) - 1)
    for f in range(frames_min - 1, len(idle)):
        if idle[f] in idle[1:f]:
            return int(fires[f]) + 1
    raise AssertionError("no recurring idle count")


def check_mesh_capture_no_host_sync(torch):
    """One captured mesh frame of each route, a replay, under
    ``set_sync_debug_mode("error")``; only the overflow read of a
    ``"local"`` mesh is let through, once."""
    for label, make, worlds, _, _, _, local in mesh_capture_routes(torch):
        fw = make()
        state = fleet_shard(torch, fw, worlds)
        with OverflowReads(torch, allow_sync=True) as ov, \
                LastFrameUnderSyncError(torch) as last:
            before = ov.reads
            state, outs = fw.rollout_cadence(state, replay_ticks(fw), seed=0)
            torch.cuda.synchronize()
        finite = bool(torch.isfinite(outs.pose).all())
        emit({"phase": f"mesh_capture_no_host_sync_{label}",
              "last_frame_replayed": last.replayed,
              "overflow_reads": ov.reads - before, "frames":
              int(outs.fired.shape[0]), "pose_finite": finite})
        require(last.replayed == 1 and finite,
                f"{label}: the last frame was not a replay")
        require(ov.reads == (int(outs.fired.shape[0]) if local else 0),
                f"{label}: {ov.reads} overflow reads")


def fleet_shard(torch, fw, worlds):
    from slamrs_tpu_torch.parallel import fleet

    return fleet.shard_world_state(fw.init((worlds,)), fw.mesh, worlds)


def check_mesh_captures(torch):
    """Every mesh route captured against eager, then the sync check;
    returns each route's captured launch counts."""
    t0 = time.perf_counter()
    counts = {label: check_mesh_capture(torch, label, make, w, n, exact,
                                        at_most, local)
              for label, make, w, n, exact, at_most, local
              in mesh_capture_routes(torch)}
    check_mesh_capture_no_host_sync(torch)
    emit({"phase": "mesh_capture_phases_time",
          "seconds": time.perf_counter() - t0})
    return counts


def check_tick_capture(torch, label, make, n_steps, exact):
    """``FusedWorld.rollout`` eager (``capture=False``) beside its tick
    programs (``capture=True``): bitwise under injected draws and under
    the seed, launches equal and the route's kernels a scan tick, two
    graphs (idle and scan) replayed; host launch calls a tick over a
    profiled window of 10 scans.  Returns the captured counts."""
    import dataclasses

    t0 = time.perf_counter()
    fw = make()
    kw = capture_draws(fw, (), n_steps, 13)
    same, runs = {}, {}
    for draws, extra in (("injected", kw), ("seed", {})):
        runs = {c: capture_run(torch, fw, (), n_steps, c, method="rollout",
                               **extra) for c in (False, True)}
        same[draws] = (same_state(torch, runs[False]["state"],
                                  runs[True]["state"])
                       and same_state(torch, runs[False]["outs"],
                                      runs[True]["outs"]))
    stats = dataclasses.replace(fw.capture_stats)
    scans = int(runs[True]["outs"].fired.sum())
    counts, eager_counts = runs[True]["counts"], runs[False]["counts"]
    timed = {c: runs[c]["seconds"] for c in runs}
    # the eager loop over its first 30 ticks; the tick programs over 60
    # replayed ticks after 20 (the first runs and captures)
    fires = fw.fire_schedule(n_steps, 0.0)[0]
    eager, window = profiled_pair(torch, fw, (), fires, "rollout", 30, 20,
                                  60, per_tick=True)
    rate = {"eager": (eager, 30), "captured": (window.summary, 60)}
    kinds = sorted(k[1] for k in stats.launches)  # ("tick", kind)
    emit({"phase": f"rollout_tick_capture_{label}", "ticks": n_steps,
          "scan_ticks": scans, "bitwise_injected": same["injected"],
          "bitwise_seed": same["seed"], "launch_counts": counts,
          "eager_launch_counts": eager_counts, "graphs": stats.graphs,
          "graph_keys": kinds, "eager_ticks": stats.eager,
          "replays": stats.replays, "capture_s": stats.capture_seconds,
          "copy_back_bytes_per_tick": {
              k[1]: v for k, v in stats.copy_back_bytes.items()},
          "host_launch_calls_per_tick": {
              c: r["host_calls"] / k for c, (r, k) in rate.items()},
          "device_busy_us_per_tick": {
              c: 1e6 * r["busy"] / k for c, (r, k) in rate.items()},
          "idle_share": {c: r["idle"] for c, (r, _) in rate.items()},
          "profiled_ticks": {"eager": 30, "captured": 60,
                             "captured_replays": window.replays},
          "window_ticks_per_s": 60 / window.summary["seconds"],
          "ticks_per_s": {"eager": n_steps / timed[False],
                          "captured": n_steps / timed[True]},
          "seconds": time.perf_counter() - t0})
    require(same["injected"] and same["seed"],
            f"tick capture {label}: the captured rollout differs from the "
            "eager loop")
    require(counts == eager_counts,
            f"tick capture {label}: launches {counts} != {eager_counts}")
    check_kernels_a_frame(f"tick capture {label}", counts, scans, exact, {})
    require(kinds == ["idle", "scan"]
            and stats.replays + stats.eager == n_steps,
            f"tick capture {label}: graphs {kinds}")
    check_profiled(f"tick capture {label}", eager, window)
    return counts


def check_tick_captures(torch):
    k1 = dict(NO_KERNELS, fused_update=1)
    return {label: check_tick_capture(torch, label, make, n, exact)
            for label, make, n, exact in (
                ("headline_0.05m", lambda: headline_world(torch, 0.05), 300,
                 k1),
                ("icp_test_yaml", lambda: preset_world(torch,
                                                       "icp_test.yaml"),
                 300, dict(NO_KERNELS, nn_argmin=10, icp_solve=11)),
                ("landmarks_yaml", lambda: preset_world(torch,
                                                        "landmarks.yaml"),
                 300, NO_KERNELS))}


def captured_launches(counts, name):
    return {label: c[name] for label, c in counts.items() if c[name]}


def _spec(geom):
    from slamrs_tpu_torch.ops.grid import GridSpec2D

    return GridSpec2D(*geom)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from slamrs_tpu_torch import kernels
    from slamrs_tpu_torch.ops import fused, tiles
    from slamrs_tpu_torch.ops.grid import GridSpec2D

    card = gpu_info()
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [src.name for src in kernels.sources()],
          "flags": " ".join(kernels.NVCC_FLAGS)})

    nn_launched = check_nn_launches(torch)
    t_sim = check_sim_frame(torch)
    spec05 = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    spec02 = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.02)
    worst = check_kernel(torch, fused, spec05, "0.05m")
    worst = max(worst, check_kernel(torch, fused, spec02, "0.02m"))

    fw05 = headline_world(torch, 0.05)
    counts, _, _ = check_rollout(torch, fw05, 300, "0.05m_300", RMSE_GATE_M)
    launches = counts["fused_update"]
    check_rollout(torch, headline_world(torch, 0.02), 150, "0.02m_150")

    times = {}
    for label, spec in (("0.05m", spec05), ("0.02m", spec02)):
        args, kw = kernel_case(torch, fused, spec, 1024, 3, 360, True)
        grids, poses, a0, dist, valid, present, _, nb, max_range = args
        anc = kw["ancestors"]
        prep = fused.prepare(grids.shape[1], grids.shape[2], poses, a0, dist,
                             valid, present, spec, nb, max_range, kw["dphi"])
        # kernel alone against the plain version of the same math (lineage
        # gather included), both on the same prepared inputs; the wrapper
        # adds the host-side preparation
        ms = time_call(torch, lambda: fused.launch_kernel(grids, anc, prep,
                                                           spec, nb))
        plain_ms = time_call(torch, lambda: fused.plain_update(
            grids[anc.long()], prep, spec, nb))
        wrapper_ms = time_call(torch, lambda: fused.fused_update(*args, **kw),
                               hide_host=False)
        # lineage mode: each ancestor map read once, every map written;
        # operations on the scan disc's cells only.  The design reads each
        # particle's ancestor map (repeats may come from L2), writes its
        # output map, and computes the box
        el = grids.element_size()
        map_bytes = grids[0].numel() * el
        nbytes = (int(torch.unique(anc).numel()) + 1024) * map_bytes
        bound, by = fused_bound(nbytes, disc_cells(torch, spec, prep,
                                                   grids.shape[2]))
        window = 1024 * prep.wr * grids.shape[2]
        box = box_cells(torch, prep, grids.shape[2], el)
        times[label] = (ms, plain_ms, bound, by)
        emit({"phase": f"kernel_time_{label}", "shape": list(grids.shape),
              "kernel_us": ms * 1e3, "plain_us": plain_ms * 1e3,
              "wrapper_with_host_us": wrapper_ms * 1e3,
              "bound_us": bound * 1e3, "bound_by": by,
              "window_cells": window, "box_cells": box,
              "box_design_cost_us":
              fused_bound(2 * 1024 * map_bytes, box)[0] * 1e3,
              "kernel_tb_per_s_of_design_bytes":
              2 * 1024 * map_bytes / ms / 1e9})

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = fw05.rollout_cadence(fw05.init(), 900, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    err = outs.grid_pose[:, :2] - outs.pose[:, :2]
    emit({"phase": "rollout_time_0.05m_900", "ticks": 900,
          "frames": int(outs.fired.shape[0]), "seconds": seconds,
          "ticks_per_s": 900 / seconds,
          "grid_pose_rmse_xy_m": float(torch.sqrt((err ** 2).mean())),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    del state, outs

    # where the time goes: device busy time and launches per tick
    profile_rollout(torch, fw05, "0.05m_300")

    # BASELINE config 3: K2, K3 and K1 in place on the card
    spec3 = _spec(CONFIG3)
    torch.cuda.reset_peak_memory_stats()
    cow_err = check_cow(torch)
    tiled_err = check_tiled(torch, spec3, "config3")
    spec_k = _spec((-2.0, -2.0, 4.0, 4.0, 0.02))
    hb = tiles.auto_band_rows(spec_k, 1.0)
    if hb is None or tiles.span_of(spec_k, 1.0, hb) < 3:
        raise AssertionError("0.02 m tiled maps did not pick a k-band span")
    tiled_err = max(tiled_err, check_tiled(torch, spec_k, "kspan"))
    for far in (False, True):
        worst = max(worst, check_k3_vs_k1(torch, spec3, far))
    emit({"phase": "config3_checks_memory",
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    tiled_counts, cow_counts = check_config3_rollouts(torch)
    check_no_host_sync(torch)
    t3 = time_config3(torch)
    time_config3_rollouts(torch)
    profile_rollout(torch, config3_world(torch), "config3_tiled_300")

    # ICP odometry and EKF landmark SLAM: K4 on the card
    nn_err = check_nn(torch)
    icp_counts, icp_outs, icp_state = check_icp_world(torch)
    ekf_world, ekf_state = check_ekf_world(torch)
    check_icp_ekf_no_host_sync(torch, icp_state.icp, ekf_world,
                               ekf_state.ekf)
    t4 = time_nn(torch, nn_launched)
    t_solve = check_icp_solve(torch)
    time_icp_batch(torch)
    time_icp_ekf_rollouts(torch)

    # grid SLAM's dda and dense integrators: plain PyTorch, no kernel
    check_grid_ops(torch)
    grid_slam_world = check_grid_slam_yaml(torch)
    for integrate in ("dda", "dense"):
        check_rollout(torch, headline_world(torch, 0.05, integrate,
                                            "float32"),
                      300, f"{integrate}_0.05m_300", RMSE_GATE_M,
                      expect=NO_KERNELS)
    check_path_deviation(torch)
    check_nonfused_no_host_sync(torch)
    time_nonfused_rollouts(torch, grid_slam_world)

    # fleets: batched worlds on one card (BASELINE config 5, bench.py's
    # fleet cell), K1 over a world axis and one flattened K2 pass
    spec_fleet = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.02)
    worst = max(worst, check_k1_fleet(torch, spec_fleet))
    cow_fleet = check_cow_fleet(torch)
    fleet_counts, _, _ = check_fleet_rollout(
        torch, fleet_world(torch), FLEET_WORLDS, 300, "256x10_0.02m_300",
        rmse_gate=GRID_SLAM_RMSE_GATE_M,
        expect={"fused_update": "frames", "fused_update_in_place": "frames",
                "fused_update_tiled": 0, "nn_argmin": 0},
        at_most={"cow_copy": "frames"})
    check_fleet_card_vs_cpu(torch)
    tiled_fleet_counts, icp_fleet_counts = check_other_fleets(torch,
                                                              icp_outs)
    check_fleet_no_host_sync(torch)
    t_fleet = time_fleet(torch, spec_fleet)

    # the host graph: the App's nodes on the card, the CLI, checkpoints
    app_k1 = check_app_grid_slam_fused(torch)
    app_k4 = check_app_icp(torch)
    check_app_grid_slam_yaml(torch)
    check_app_landmarks(torch)
    check_app_no_host_sync(torch)
    check_app_no_host_sync_icp_ekf(torch)
    for name in APP_PRESETS:
        profile_app(torch, name, 300)
    with tempfile.TemporaryDirectory() as tmp:
        check_cli_run(torch, tmp)
        check_checkpoint_card(torch, tmp)

    # the robot I/O: the native library, the virtual robot on the card,
    # replay through the App (K4), and a live link to the robot process
    with tempfile.TemporaryDirectory() as tmp:
        card_robot = drive_robot(torch, "cuda")
        cpu_robot = drive_robot(torch, "cpu")
        revs = scan_frames(card_robot[0])
        log_path = Path(tmp) / "robot.bin"
        log_path.write_bytes(b"".join(f.scan_data for f in revs))
        check_native_build(torch, log_path.read_bytes())
        check_virtual_robot_card_vs_cpu(card_robot, cpu_robot)
        check_replay_log(log_path, len(revs))
        replay_k4 = check_app_neato_replay(torch, log_path, card_robot[1])
        check_file_loader_no_host_sync(torch, log_path)
        profile_app(torch, "neato_replay.yaml", 70,
                    text=replay_yaml(log_path))
        # the App's node programs as CUDA graphs against op by op
        app_cap = check_app_captures(torch, log_path)
    check_robot_link_card(torch)

    # sharded fleets: (world, particle) meshes whose entries are the card
    t0 = time.perf_counter()
    c5_dp_counts, c5_local_counts = check_mesh_config5(torch)
    headline_mesh_counts = check_mesh_headline(torch)
    c3_mesh_counts = check_mesh_config3(torch)
    icp_mesh_counts = check_mesh_other_filters(torch)
    check_mesh_dryrun_legs(torch)
    with tempfile.TemporaryDirectory() as tmp:
        check_mesh_checkpoint(torch, tmp)
    check_mesh_no_host_sync(torch)
    emit({"phase": "mesh_phases_time", "seconds": time.perf_counter() - t0})

    # the cadence rollout as CUDA graphs, against the eager loop
    cap = check_captures(torch)
    # sharded frames and the tick rollout as CUDA graphs
    mesh_cap = check_mesh_captures(torch)
    tick_cap = check_tick_captures(torch)
    # fused against dda over 500 captured node updates
    check_longrun(torch)

    k1_ms, k1_plain, k1_bound, k1_by = times["0.05m"]
    emit({"kernels": [
        {"name": "fused_update", "route": "cuda",
         "source": "slamrs_tpu_torch/csrc/fused_update.cu",
         "replaces": "slamrs_tpu/ops/fused.py:1619",
         "launches": launches, "max_abs_err": worst,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None,
         "fleet_launches": fleet_counts["fused_update"],
         **{f"fleet_{k}": v for k, v in t_fleet.items()},
         "captured_launches": captured_launches(cap, "fused_update"),
         "app_launches": app_k1["fused_update"],
         "app_capture_launches": captured_launches(app_cap, "fused_update"),
         "mesh_launches": {
             "config5_8x1_300": c5_dp_counts["fused_update"],
             "config5_4x2_local_300": c5_local_counts["fused_update"],
             "headline_2x4_gather_300":
             headline_mesh_counts["fused_update"]},
         "mesh_capture_launches": captured_launches(mesh_cap,
                                                    "fused_update"),
         "tick_capture_launches": captured_launches(tick_cap,
                                                    "fused_update")},
        {"name": "cow_copy", "route": "cuda",
         "source": "slamrs_tpu_torch/csrc/cow_copy.cu",
         "replaces": "slamrs_tpu/ops/cow.py:187",
         "launches": cow_counts["cow_copy"], "max_abs_err": cow_err,
         **t3["cow_copy"], "fleet_launches": fleet_counts["cow_copy"],
         **{f"fleet_{k}": v for k, v in cow_fleet.items()},
         "captured_launches": captured_launches(cap, "cow_copy"),
         "mesh_launches": {"config5_8x1_300": c5_dp_counts["cow_copy"]},
         "mesh_capture_launches": captured_launches(mesh_cap, "cow_copy")},
        {"name": "fused_update_tiled", "route": "cuda",
         "source": "slamrs_tpu_torch/csrc/fused_update_tiled.cu",
         "replaces": "slamrs_tpu/ops/tiles.py:533",
         "launches": tiled_counts["fused_update_tiled"],
         "max_abs_err": tiled_err, **t3["fused_update_tiled"],
         "fleet_launches": tiled_fleet_counts["fused_update_tiled"],
         "captured_launches": captured_launches(cap, "fused_update_tiled"),
         "mesh_launches": {"config3_tiled_2x1_90":
                           c3_mesh_counts["fused_update_tiled"]},
         "mesh_capture_launches": captured_launches(mesh_cap,
                                                    "fused_update_tiled")},
        {"name": "nn_argmin", "route": "cuda",
         "source": "slamrs_tpu_torch/csrc/nn_argmin.cu",
         "replaces": "slamrs_tpu/ops/icp.py:111",
         "launches": icp_counts["nn_argmin"], "max_abs_err": nn_err,
         **t4["mapper_1x360x16384_qc10000"],
         "fleet_launches": icp_fleet_counts["nn_argmin"],
         "app_launches": app_k4["nn_argmin"],
         "app_capture_launches": captured_launches(app_cap, "nn_argmin"),
         "captured_launches": captured_launches(cap, "nn_argmin"),
         "replay_launches": replay_k4["nn_argmin"],
         "mesh_launches": {"icp_test_4x1_300": icp_mesh_counts["nn_argmin"]},
         "mesh_capture_launches": captured_launches(mesh_cap, "nn_argmin"),
         "tick_capture_launches": captured_launches(tick_cap, "nn_argmin")},
        {"name": "icp_solve", "route": "cuda",
         "source": "slamrs_tpu_torch/csrc/icp_solve.cu",
         "replaces": "slamrs_tpu/ops/icp.py:212",
         "launches": icp_counts["icp_solve"], "library_ms": None,
         **t_solve["mapper_1x360x16384_step0.05"],
         **{f"bench_{k}": v
            for k, v in t_solve["bench_2048x360x360"].items()},
         "fleet_launches": icp_fleet_counts["icp_solve"],
         "app_launches": app_k4["icp_solve"],
         "app_capture_launches": captured_launches(app_cap, "icp_solve"),
         "captured_launches": captured_launches(cap, "icp_solve"),
         "replay_launches": replay_k4["icp_solve"],
         "mesh_launches": {"icp_test_4x1_300": icp_mesh_counts["icp_solve"]},
         "mesh_capture_launches": captured_launches(mesh_cap, "icp_solve"),
         "tick_capture_launches": captured_launches(tick_cap, "icp_solve")},
        {"name": "sim_frame", "route": "cuda",
         "source": "slamrs_tpu_torch/csrc/sim_frame.cu",
         "replaces": "slamrs_tpu/graph/compile.py:387 (XLA: idle ticks, "
                     "step's motion and lidar)",
         "max_abs_err": 0, "library_ms": None, **t_sim["1x_k5"],
         **{f"{label}_{k}": v for label, t in t_sim.items()
            if label != "1x_k5" for k, v in t.items()},
         "captured_launches": captured_launches(cap, "sim_frame"),
         "app_capture_launches": captured_launches(app_cap, "sim_frame"),
         "mesh_capture_launches": captured_launches(mesh_cap, "sim_frame"),
         "tick_capture_launches": captured_launches(tick_cap, "sim_frame")}
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
