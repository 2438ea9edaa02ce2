"""Node lifecycle contract and the message types carried on topics.

Counterpart of ``slamrs_tpu/graph/node.py``.  Observations
(:class:`ScanOdometry`, :class:`LandmarkOdometry`) carry the port's
tensor tuples and stay on the device of the node that published them.
The pose and map messages hold numpy arrays, as in the JAX package, but
a message built from a device tensor does not wait for the device: it
starts the copy into pinned host memory and records an event, and the
first read of the field waits for that event.  So publishing a pose is
no host sync, and the host waits only where a consumer reads it (a
drawn or saved topic, a test).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


class Node:
    """A node of the graph: ``update`` runs once per app frame.  A node
    with device updates runs them through ``program``
    (``graph/capture.Program``) once :meth:`use_programs` is called, and
    op by op while it is None."""

    program = None

    def update(self) -> None:
        pass

    def use_programs(self, graphs: bool) -> None:
        """Run the device updates as programs on static buffers: captured
        CUDA graphs with ``graphs``, uncaptured without.  A node with no
        device update has none."""

    def draw(self, viz: Optional[Any] = None) -> None:  # optional viz hook
        pass

    def terminate(self) -> None:  # cleanup (threads, sockets)
        pass


class NodeConfig:
    """A node's YAML fields; ``instantiate`` builds the node on
    ``device``."""

    def instantiate(self, pubsub, device) -> Node:
        raise NotImplementedError


class HostCopy:
    """A tensor's copy to host memory, started without waiting for the
    device; :meth:`numpy` waits for it.  bf16 is widened to f32 (numpy
    has no bf16)."""

    __slots__ = ("_buf", "_event")

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        self._event = None
        if t.is_cuda:
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = t.clone()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._buf.numpy()


class _OnHost:
    """A message field holding a numpy array.  A tensor assigned to it
    becomes a :class:`HostCopy`, resolved on the first read."""

    def __set_name__(self, owner, name):
        self.slot = "_" + name

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        v = getattr(obj, self.slot)
        if isinstance(v, HostCopy):
            v = v.numpy()
            setattr(obj, self.slot, v)
        return v

    def __set__(self, obj, v):
        setattr(obj, self.slot,
                HostCopy(v) if isinstance(v, torch.Tensor) else np.asarray(v))


# ---- topic payload types -------------------------------------------------

@dataclasses.dataclass
class ScanOdometry:
    """(Observation, Odometry) tuple topic payload, tensors on the
    publisher's device."""

    scan: Any  # slamrs_tpu_torch.core.types.Scan
    odometry: Any  # OdometryReading


@dataclasses.dataclass
class LandmarkOdometry:
    landmarks: Any  # LandmarkScan
    odometry: Any


class PoseMsg:
    """Pose topic payload (x, y, theta)."""

    pose = _OnHost()  # f32[3]

    def __init__(self, pose):
        self.pose = pose


class GridMapMessage:
    """Occupancy map: ``position`` f32[2] (world coordinates of the
    lower-left corner), ``resolution`` (m), ``data`` f32[H, W]
    probabilities."""

    position = _OnHost()
    data = _OnHost()

    def __init__(self, position, resolution: float, data):
        self.position = position
        self.resolution = resolution
        self.data = data


class PointMapMessage:
    """Point map: ``points`` f32[N, 2]."""

    points = _OnHost()

    def __init__(self, points):
        self.points = points


class LandmarkMapMessage:
    """Landmark map: ``means`` f32[N, 2], ``covariances`` f32[N, 2, 2],
    ``seen`` bool[N]."""

    means = _OnHost()
    covariances = _OnHost()
    seen = _OnHost()

    def __init__(self, means, covariances, seen):
        self.means = means
        self.covariances = covariances
        self.seen = seen
