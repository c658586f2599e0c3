"""Device meshes for sharded execution (counterpart of
``repro.launch.mesh``).

The reference is single-controller: one process drives every device of a
``jax.sharding.Mesh``.  The port keeps that design with a small
:class:`Mesh` of ``torch.device`` objects, driven by one process.  A
device may appear more than once; its shards then share it, as the
reference's faked CPU devices share one host:

    mesh = make_stencil_mesh((2, 2), devices=["cuda:0"] * 4)  # one card
    mesh = make_stencil_mesh((2, 4))        # 8 visible GPUs, in order
    prog = compile_stencil(spec, (256, 512), t=4, mesh=mesh)
    y = prog.run_sharded(x, 64)

Stencil meshes (``make_stencil_mesh``) have one axis per sharded tensor
dimension: axis ``shard<k>`` shards dim ``k``.  Without ``devices=`` a
mesh takes the visible CUDA devices in order and refuses when there are
too few.  :func:`ensure_fake_devices` is the counterpart of the
reference's helper of that name, which faked CPU devices for XLA: here it
builds the device list itself, ``n`` CPU shards, or the visible GPUs
cycled.

LM meshes have the axes ``data`` and ``model`` (``make_host_mesh``), or
``pod``, ``data`` and ``model`` (``make_production_mesh``); the LM
half's parallelism (``models/parallel.py``) runs over them.  Nothing
here touches CUDA at import time.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.device import resolve_device


class Mesh:
    """Devices laid out in a named grid, as ``jax.sharding.Mesh``:
    ``axis_names``, ``shape`` (axis name → size), ``size`` and
    ``devices`` (a numpy object array of ``torch.device`` in the mesh's
    shape; ``stands_for`` is ``None``, see :func:`representative`).

        mesh = Mesh(np.array([torch.device("cpu")] * 4).reshape(2, 2),
                    ("shard0", "shard1"))
        mesh.shape["shard1"], mesh.size      # -> 2, 4
    """

    def __init__(self, devices: np.ndarray, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh devices have {devices.ndim} dims but "
                             f"{len(axis_names)} axis names {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)
        self.stands_for = None


def device_summary(devices) -> str:
    """``cuda:0x4``-style summary of a device list: runs of one device
    are written ``<device>x<count>``."""
    out: list[list] = []
    for d in devices:
        d = str(d)
        if out and out[-1][0] == d:
            out[-1][1] += 1
        else:
            out.append([d, 1])
    return ",".join(d if n == 1 else f"{d}x{n}" for d, n in out)


def _visible_cuda() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def ensure_fake_devices(n: int, device="cpu") -> list[torch.device]:
    """``n`` devices for a mesh of ``n`` shards: ``n`` CPU shards for
    ``device="cpu"``, else the visible CUDA devices cycled (on one card,
    ``n`` shards of ``cuda:0``).

        ensure_fake_devices(4)                  # [cpu, cpu, cpu, cpu]
        ensure_fake_devices(4, "cuda")          # one card: cuda:0 x 4
    """
    n = int(n)
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n
    visible = _visible_cuda()
    if not visible:
        raise RuntimeError(
            "no CUDA device is visible; pass device=\"cpu\" for CPU shards")
    return [visible[i % len(visible)] for i in range(n)]


def _mk(shape, axes, devices=None) -> Mesh:
    n = math.prod(shape)
    if devices is None:
        devs = _visible_cuda()
        if len(devs) < n:
            raise RuntimeError(
                f"need {n} devices, have {len(devs)} visible CUDA devices; "
                f"pass devices= to place shards yourself (a device may "
                f"repeat: devices=[\"cuda:0\"] * {n} shares one card, "
                f"devices=[\"cpu\"] * {n} runs on the CPU)")
    else:
        devs = [resolve_device(d) for d in devices]
        if len(devs) < n:
            raise ValueError(f"need {n} devices, have {len(devs)} in "
                             "devices=")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape), axes)


def make_mesh(shape, axes, devices=None) -> Mesh:
    """Arbitrary mesh for tests/examples."""
    return _mk(tuple(shape), tuple(axes), devices)


def make_stencil_mesh(shape, devices=None) -> Mesh:
    """A domain-decomposition mesh for ``compile_stencil(..., mesh=)``.

    Mesh axis ``k`` (named ``shard<k>``) shards tensor dimension ``k`` of
    the stencil domain; axes of size 1 leave their dimension unsharded.
    Devices are taken from ``devices`` (which may repeat a device), or
    the visible CUDA devices in order.

        mesh = make_stencil_mesh((2, 4))        # 8 GPUs: dims 0 and 1
        mesh = make_stencil_mesh((2, 2), devices=["cuda:0"] * 4)
        prog = compile_stencil(spec, (256, 512), t=4, mesh=mesh)
        y = prog.run_sharded(x, 64)
    """
    shape = tuple(int(n) for n in shape)
    if not shape or any(n < 1 for n in shape):
        raise ValueError(f"mesh shape must be positive ints, got {shape}")
    return _mk(shape, tuple(f"shard{k}" for k in range(len(shape))),
               devices)


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   devices=None) -> Mesh:
    """Smoke-test mesh over the devices the host has (the visible GPUs,
    or ``devices``)."""
    n = len(devices) if devices is not None else len(_visible_cuda())
    if n_data * n_model > n:
        raise RuntimeError(f"need {n_data * n_model} devices for a "
                           f"({n_data}, {n_model}) mesh, have {n}")
    return _mk((n_data, n_model), ("data", "model"), devices)


def lm_mesh(n_data: int, n_model: int, device) -> Mesh | None:
    """The ``(data, model)`` mesh the LM launchers run on: ``None`` for
    ``(1, 1)`` (the unsharded path), else ``n_data × n_model`` shards of
    ``device`` (CPU shards, or the visible GPUs cycled)."""
    n = n_data * n_model
    if n == 1:
        return None
    return make_host_mesh(n_data, n_model,
                          devices=ensure_fake_devices(n, device))


def representative(mesh: Mesh) -> Mesh:
    """One position standing for every position of ``mesh``, whose shards
    all hold one local shape each (the LM executor's specs and the
    stencil layouts split every dim evenly or not at all): axis names,
    ``shape`` and ``size`` are ``mesh``'s, ``devices`` holds its first
    device alone, and ``stands_for`` is ``mesh``.  The collectives of
    ``core/distributed.py`` take that position as every member of its
    group, so their results have the whole mesh's shapes: a program
    traced over it runs what each device of ``mesh`` runs, once (the
    dry run, ``launch/dryrun.py``).

        rep = representative(make_production_mesh(devices=["meta"] * 256))
        rep.devices.shape, rep.shape        # (1, 1), {"data": 16, ...}
    """
    devices = np.empty((1,) * mesh.devices.ndim, dtype=object)
    devices.flat[0] = mesh.devices.flat[0]
    rep = Mesh(devices, mesh.axis_names)
    rep.shape, rep.size, rep.stands_for = dict(mesh.shape), mesh.size, mesh
    return rep


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> Mesh:
    """16×16 ``(data, model)`` (one pod, 256 devices) or 2×16×16 ``(pod,
    data, model)`` (two pods, 512).  ``pod`` carries only the once-a-step
    gradient reduction, ``data`` the data parallelism and the ZeRO
    shards, ``model`` the tensor and expert parallelism.  Without
    ``devices=`` it needs that many visible GPUs.

        mesh = make_production_mesh(devices=["cpu"] * 256)
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, devices)
