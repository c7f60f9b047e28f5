"""Sharded batch verification over a mesh of devices: the port's copy of
tendermint_tpu/parallel/sharded.py.

Verification is embarrassingly parallel over the validator axis, so the
multi-device design is the reference's: split the trailing batch axis of
every input across a mesh, run the single-device kernels on each shard's own
device, and reduce across shards only the O(1) aggregates: the voting-power
tallies, and the RLC check's one partial point a shard.

A mesh (`Mesh`, from `make_mesh`) is a numpy array of torch devices plus its
axis names, the counterpart of a `jax.sharding.Mesh`. Two shapes, as in the
reference:

- 1D ("vals",): commit verification sharded across validators;
- 2D ("blocks", "vals"): a [..., NB, NV] batch sharded across blocks AND
  validators (`_aligned`: the last batch axes map onto the mesh axes).

A device may appear more than once in a mesh (JAX's `Mesh` refuses that).
Such a mesh is the torch counterpart of the reference's forced host device
count: four shards of one card, or of the CPU in tests, run every sharded
code path on one device. Each shard then has a key of its own for the health
model and telemetry, `<device>#<shard>` (e.g. "cuda:0#2"); a device that
appears once keeps `str(device)` ("cuda:1"). Nothing builds a mesh of
repeated devices by itself: crypto/batch.py's "auto" mesh takes distinct
healthy cards, and only a caller that pins the mesh (tests, chip_smoke.py)
repeats one.

A runner launches every shard's kernels from the calling thread, each on its
shard's device (the kernel wrappers launch under the tensor's own device,
ops/cuda_fe.py), then syncs. The reference's `all_gather` of the RLC partial
points becomes one copy of each shard's (4, 20) int32 partial onto the mesh's
first device (320 bytes a shard), where the padd kernel adds them in a tree
and the identity check reads the sum. Every dispatch runs under `_guarded`:
the chaos shard-fault hook first (chaos/device.py), then the work; a raise
is scored against parallel/health.MESH_HEALTH by shard key, a clean return
clears the participants' streaks. Every flush, prep and mesh is recorded in
parallel/telemetry.py with the reference's fields.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from tendermint_tpu_torch.libs import forensics as _forensics
from tendermint_tpu_torch.ops import msm_torch
from tendermint_tpu_torch.ops.ed25519_torch import verify_prepared
from tendermint_tpu_torch.parallel import health as _mesh_health
from tendermint_tpu_torch.parallel import telemetry as _mesh_tm

# the bytes of one shard's partial point, (4, 20) int32: the gather's traffic
PARTIAL_BYTES = 4 * 20 * 4


class ShardFaultError(RuntimeError):
    """A failure of exactly ONE shard of a sharded dispatch, carrying its
    attribution: the shard index and the shard's key. Chaos injection
    (chaos/device.py) raises these from the shard-fault hook below; the
    health model (parallel/health.py) reads .device / .shard directly
    instead of probing the whole mesh."""

    def __init__(self, site: str, shard: int, device) -> None:
        super().__init__(f"shard fault at {site}: shard {shard} ({device})")
        self.site = site
        self.shard = int(shard)
        self.device = str(device)


_SHARD_FAULT_HOOK = None  # callable(site: str, devices: list[str]); may raise


def set_shard_fault_hook(fn) -> None:
    """Install (or clear, with None) the chaos shard-fault hook. It runs at
    every sharded dispatch site with the participating shard keys, so a chaos
    schedule can kill exactly one shard mid-flush."""
    global _SHARD_FAULT_HOOK
    _SHARD_FAULT_HOOK = fn


def _shard_fault(site: str, devices) -> None:
    hook = _SHARD_FAULT_HOOK
    if hook is not None:
        hook(site, devices)


def _guarded(site: str, devices, fn, *args):
    """Run one sharded dispatch: the chaos shard hook fires first (so an
    injected fault lands on exactly this dispatch), any raise is scored
    against the per-device health model (stamped ``_mesh_scored`` so callers
    further up never score it twice), and a clean return clears the
    participants' failure streaks, the call's wall feeding stall scoring."""
    t0 = time.perf_counter()
    try:
        _shard_fault(site, devices)
        out = fn(*args)
    except Exception as e:
        if not getattr(e, "_mesh_scored", False):
            _mesh_health.MESH_HEALTH.record_failure(devices, e)
            try:
                e._mesh_scored = True
            except Exception:
                pass
        raise
    _mesh_health.MESH_HEALTH.record_success(devices, time.perf_counter() - t0)
    return out


class Mesh:
    """Devices on named axes: `devices` a numpy object array of torch
    devices shaped like the mesh, `axis_names` one name an axis, `keys` one
    distinct string a shard (flat order), `platform` the devices' type."""

    __slots__ = ("devices", "axis_names", "keys", "platform")

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {devices.ndim} with axes {tuple(axis_names)}")
        flat = list(devices.reshape(-1))
        if len({d.type for d in flat}) != 1:
            raise ValueError("a mesh's devices must be of one type")
        names = [str(d) for d in flat]
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.keys = [k if names.count(k) == 1 else f"{k}#{i}" for i, k in enumerate(names)]
        self.platform = flat[0].type

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list:
        return list(self.devices.reshape(-1))


def make_mesh(devices=None, shape=None, axis_names=("vals",)) -> Mesh:
    """Build a device mesh. Default: every visible card on one "vals" axis.
    `devices` may repeat a device (see the module docstring). Also the
    mesh-telemetry anchor: every mesh built here lands in the `mesh` block
    of /debug/mesh (parallel/telemetry.py)."""
    devices = list(devices) if devices is not None else _mesh_health._visible_devices()
    if not devices:
        raise ValueError("make_mesh: no device")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    if shape is not None:
        arr = arr.reshape(shape)
    mesh = Mesh(arr, axis_names)
    _mesh_tm.record_mesh(mesh.axis_names, arr.shape, mesh.keys, mesh.platform)
    return mesh


def _aligned(mesh: Mesh, batch_rank: int):
    """Right-align mesh axes onto the trailing batch axes: a batch of rank
    R >= M (mesh rank) maps its LAST M axes onto the mesh axes and leaves
    the leading R-M axes unsharded."""
    mesh_rank = len(mesh.axis_names)
    if batch_rank < mesh_rank:
        raise ValueError(
            f"batch rank {batch_rank} < mesh rank {mesh_rank}: "
            "every mesh axis needs a batch axis to shard"
        )
    lead = batch_rank - mesh_rank
    return (None,) * lead + tuple(mesh.axis_names)


def _shard_batch_shape(mesh: Mesh, batch_shape) -> tuple:
    """Per-device shard of a right-aligned batch shape."""
    spec = _aligned(mesh, len(batch_shape))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return tuple(
        d // sizes[ax] if ax is not None else d for d, ax in zip(batch_shape, spec)
    )


def _shard_slices(mesh: Mesh, batch_shape) -> List[tuple]:
    """One index tuple into the batch axes per shard, in the mesh's flat
    order; every sharded axis must divide by its mesh axis."""
    spec = _aligned(mesh, len(batch_shape))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for d, ax in zip(batch_shape, spec):
        if ax is not None and d % sizes[ax]:
            raise ValueError(f"batch axis {d} does not divide by mesh axis {ax}={sizes[ax]}")
    per = _shard_batch_shape(mesh, batch_shape)
    lead = len(batch_shape) - len(mesh.axis_names)
    return [(slice(None),) * lead + tuple(slice(i * per[lead + k], (i + 1) * per[lead + k])
                                          for k, i in enumerate(idx))
            for idx in np.ndindex(*mesh.devices.shape)]


class ShardedArray:
    """A host array split over a mesh (shard_batch_arrays): `shards`, one
    tensor a shard on that shard's device, each (lead..., lanes) with its
    batch axes flattened; `shape`, the whole array's shape."""

    __slots__ = ("shards", "shape")

    def __init__(self, shards: list, shape: tuple) -> None:
        self.shards = shards
        self.shape = tuple(shape)


def _split(mesh: Mesh, x, nlead: int = 1) -> ShardedArray:
    """`x` (nlead non-batch axes, then the batch axes) as per-shard tensors
    on their devices, batch axes flattened."""
    if isinstance(x, ShardedArray):
        return x
    arr = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if arr.dtype == np.uint32:  # the power planes: torch sums them as int64
        arr = arr.astype(np.int64)
    shards = []
    for dev, sl in zip(mesh.flat, _shard_slices(mesh, arr.shape[nlead:])):
        part = arr[(slice(None),) * nlead + sl]
        part = np.ascontiguousarray(part.reshape(arr.shape[:nlead] + (-1,)))
        shards.append(msm_torch._to_device(part, dev))
    return ShardedArray(shards, arr.shape)


def _pad_lanes(mesh: Mesh, arrays: list) -> tuple:
    """On a 1D mesh, pad the batch axis of host arrays with zero lanes up to
    a multiple of the mesh size (a small per-signature flush can hold fewer
    lanes than the mesh has shards). Returns (arrays, lanes before)."""
    first = arrays[0]
    if isinstance(first, ShardedArray) or len(mesh.axis_names) != 1 or np.ndim(first) != 2:
        return arrays, None
    n = first.shape[-1]
    padded = -(-n // mesh.size) * mesh.size
    if padded == n:
        return arrays, n
    out = []
    for x in arrays:
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        z = np.zeros(x.shape[:-1] + (padded - n,), dtype=x.dtype)
        out.append(np.concatenate([x, z], axis=-1))
    return out, n


def _join(mesh: Mesh, parts: list, batch_shape: tuple) -> np.ndarray:
    """Per-shard flat results back into the batch layout."""
    per = _shard_batch_shape(mesh, batch_shape)
    out = np.empty(batch_shape, dtype=parts[0].dtype)
    for part, sl in zip(parts, _shard_slices(mesh, batch_shape)):
        out[sl] = part.reshape(per)
    return out


def sharded_verify(mesh: Mesh):
    """verify_prepared with the batch axis sharded across the mesh.

    Inputs [32, B] / [64, B] (or [..., NB, NV] for 2D meshes; host arrays
    or shard_batch_arrays' ShardedArrays); batch axes map onto mesh axes
    right-aligned. Each shard runs the per-signature ladder on its device.
    Returns the bool mask (numpy) in the batch layout."""
    devices = list(mesh.keys)

    def _submit(sh):
        return [verify_prepared(*(s.shards[i] for s in sh)) for i in range(mesh.size)]

    def run(a, r, s_bits, h_bits):
        (a, r, s_bits, h_bits), n = _pad_lanes(mesh, [a, r, s_bits, h_bits])
        sh = [_split(mesh, x) for x in (a, r, s_bits, h_bits)]
        batch_shape = sh[0].shape[1:]
        lanes = int(np.prod(_shard_batch_shape(mesh, batch_shape)))
        # split submit (launches) from finish (sync) so a wedged mesh names
        # its phase: the heartbeat (libs/forensics.py) is readable from
        # outside even while this thread hangs
        _forensics.beat("mesh_persig_submit")
        t0 = time.perf_counter()
        masks = _guarded("mesh_persig_submit", devices, _submit, sh)
        t1 = time.perf_counter()
        _forensics.beat("mesh_persig_finish")
        out = _join(mesh, [m.cpu().numpy() for m in masks], batch_shape)
        _mesh_tm.record_flush(
            "persig",
            ndev=mesh.size,
            shard_lanes=lanes,
            submit_s=t1 - t0,
            finish_s=time.perf_counter() - t1,
            devices=devices,
        )
        return out if n is None else out[..., :n]

    return run


def sharded_commit_step(mesh: Mesh):
    """Batched commit verification: per-shard signature verification plus
    the voting power carried by valid signatures, summed across shards;
    accepts iff valid power > 2/3 of total (the reference's tally,
    types/validator_set.go:662). Powers arrive as four 16-bit planes
    (split_powers); each shard sums its planes in int64 on its device, and
    the shards' sums are added and joined in Python ints. Returns
    (mask numpy, ok)."""
    devices = list(mesh.keys)

    def _submit(sh, planes):
        out = []
        for i in range(mesh.size):
            mask = verify_prepared(*(s.shards[i] for s in sh))
            p = planes.shards[i].to(torch.int64)
            talled = torch.where(mask[None], p, torch.zeros_like(p)).sum(dim=1)
            out.append((mask, talled, p.sum(dim=1)))
        return out

    def step(a, r, s_bits, h_bits, power_planes):
        (a, r, s_bits, h_bits, power_planes), n = _pad_lanes(
            mesh, [a, r, s_bits, h_bits, power_planes])
        sh = [_split(mesh, x) for x in (a, r, s_bits, h_bits)]
        planes = _split(mesh, power_planes)
        batch_shape = sh[0].shape[1:]
        lanes = int(np.prod(_shard_batch_shape(mesh, batch_shape)))
        _forensics.beat("mesh_commit_submit")
        t0 = time.perf_counter()
        parts = _guarded("mesh_commit_submit", devices, _submit, sh, planes)
        t1 = time.perf_counter()

        def _join_planes(per_shard) -> int:
            sums = [0] * 4
            for t in per_shard:
                for k, v in enumerate(t.cpu().tolist()):
                    sums[k] += int(v)
            return sum(v << (16 * k) for k, v in enumerate(sums))

        _forensics.beat("mesh_commit_finish")
        mask = _join(mesh, [m.cpu().numpy() for m, _, _ in parts], batch_shape)
        ok = _join_planes([t for _, t, _ in parts]) * 3 > _join_planes([t for _, _, t in parts]) * 2
        _mesh_tm.record_flush(
            "commit_step",
            ndev=mesh.size,
            shard_lanes=lanes,
            submit_s=t1 - t0,
            finish_s=time.perf_counter() - t1,
            devices=devices,
            ok=bool(ok),
        )
        return (mask if n is None else mask[..., :n]), ok

    return step


def _gather_fold(mesh: Mesh, parts: list) -> torch.Tensor:
    """The partial points (4, 20) of every shard copied onto the mesh's
    first device and added in a tree by the padd kernel
    (msm_torch._partial_fold_core); the identity check of the sum, an
    unsynced bool on that device."""
    dev0 = mesh.flat[0]
    level = [p.to(dev0) for p in parts]
    while len(level) > 1:
        nxt = [msm_torch._partial_fold_core(level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return msm_torch._partial_identity_core(level[0])


def _shard_partial(pts_bytes, perm, ends, dev, fused: bool):
    """One shard's MSM over its lanes (decompression, invalid lanes as the
    identity, the fused or unfused schedule) on `dev`: (partial (4, 20),
    lane ok (n,)), unsynced."""
    b = msm_torch._to_device(pts_bytes, dev)
    return msm_torch._rlc_partial_core(b, *msm_torch._upload(perm, ends, dev), fused)


class _LaneFlags:
    """One chunk's per-shard lane flags, copied to host memory behind each
    shard's kernels at submit time; np.asarray() waits for exactly those
    copies (an event a card shard), not for chunks submitted later."""

    def __init__(self, oks: list) -> None:
        self._flags, self._events = [], []
        for ok in oks:
            if ok.device.type == "cuda":
                host = torch.empty(ok.shape, dtype=torch.bool, pin_memory=True)
                host.copy_(ok, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(ok.device))
            else:
                host, ev = ok, None
            self._flags.append(host)
            self._events.append(ev)

    def __array__(self, dtype=None, copy=None):
        for ev in self._events:
            if ev is not None:
                ev.synchronize()
        out = np.stack([f.numpy() for f in self._flags])
        return out if dtype is None else out.astype(dtype)


def sharded_rlc_check(mesh: Mesh):
    """The RLC / Pippenger check sharded across the mesh. The MSM is a sum
    over lanes, so each shard runs the whole pipeline over its lanes (its
    host-prepped perm and bucket ends cover only its shard), giving one
    partial point; the partials are gathered onto the first device and
    added there, and the identity check reads the sum. Per-lane decompress
    flags stay per shard.

    Returns run(pts_bytes[D,32,n], perm[D,T,n], ends[D,T,256]) ->
    (batch_ok bool, lane_ok [D*n] numpy)."""
    if len(mesh.axis_names) != 1:
        raise ValueError("sharded_rlc_check expects a 1D mesh")
    ndev = mesh.size
    devices = list(mesh.keys)

    def _submit(pts_bytes, perm, ends, fused):
        parts, oks = [], []
        for d, dev in enumerate(mesh.flat):
            part, ok = _shard_partial(pts_bytes[d], perm[d], ends[d], dev, fused)
            parts.append(part)
            oks.append(ok)
        return _gather_fold(mesh, parts), oks

    def run(pts_bytes, perm, ends):
        if pts_bytes.shape[0] != ndev:
            raise ValueError(f"leading axis {pts_bytes.shape[0]} != mesh size {ndev}")
        n_sh = pts_bytes.shape[2]
        _forensics.beat("mesh_rlc_submit")
        t0 = time.perf_counter()
        bok, oks = _guarded("mesh_rlc_submit", devices, _submit, pts_bytes, perm, ends,
                            msm_torch.fused_for_lanes(n_sh))
        t1 = time.perf_counter()
        _forensics.beat("mesh_rlc_finish")
        bok = bool(bok.item())
        ok = np.concatenate([o.cpu().numpy() for o in oks])
        _mesh_tm.record_flush(
            "rlc",
            ndev=ndev,
            shard_lanes=n_sh,
            submit_s=t1 - t0,
            finish_s=time.perf_counter() - t1,
            # ONE gather of the (4, 20) int32 partial point per shard
            all_gather_bytes=ndev * PARTIAL_BYTES,
            devices=devices,
            ok=bok,
        )
        return bok, ok

    return run


def sharded_rlc_stream(mesh: Mesh):
    """The streamed planner's arm of sharded_rlc_check (crypto/batch.py): an
    over-budget flush streams fixed-bucket chunks ACROSS the mesh. Per chunk,
    each shard runs the whole pipeline over its lanes and folds the partial
    point into that shard's accumulator on its own device; after the LAST
    chunk, one gather, the tree add and the identity check give the combined
    verdict. Cross-shard traffic stays one gather a flush, not a chunk.

    Returns (run_chunk, finish):
      run_chunk(pts (D, 32, n), perm (D, T, n), ends (D, T, 256), acc)
          -> (acc' [D partials, each on its shard's device], lane flags
              (np.asarray -> (D, n) bool), both unsynced); acc is None for
              the first chunk;
      finish(acc) -> batch_ok, an unsynced bool tensor on the first device."""
    if len(mesh.axis_names) != 1:
        raise ValueError("sharded_rlc_stream expects a 1D mesh")
    ndev = mesh.size
    devices = list(mesh.keys)

    def _chunk(pts_bytes, perm, ends, acc, fused):
        out, oks = [], []
        for d, dev in enumerate(mesh.flat):
            part, ok = _shard_partial(pts_bytes[d], perm[d], ends[d], dev, fused)
            out.append(part if acc is None else msm_torch._partial_fold_core(acc[d], part))
            oks.append(ok)
        return out, _LaneFlags(oks)

    def run_chunk(pts_bytes, perm, ends, acc):
        if pts_bytes.shape[0] != ndev:
            raise ValueError(f"leading axis {pts_bytes.shape[0]} != mesh size {ndev}")
        n_sh = pts_bytes.shape[2]
        _forensics.beat("mesh_rlc_stream_submit")
        t0 = time.perf_counter()
        acc, ok = _guarded("mesh_rlc_stream_submit", devices, _chunk, pts_bytes, perm, ends,
                           acc, msm_torch.fused_for_lanes(n_sh))
        _mesh_tm.record_flush(
            "rlc_stream_chunk",
            ndev=ndev,
            shard_lanes=n_sh,
            submit_s=time.perf_counter() - t0,
            finish_s=0.0,
            devices=devices,
        )
        return acc, ok

    def finish(acc):
        _forensics.beat("mesh_rlc_stream_finish")
        t0 = time.perf_counter()
        bok = _guarded("mesh_rlc_stream_finish", devices, _gather_fold, mesh, acc)
        _mesh_tm.record_flush(
            "rlc_stream_finish",
            ndev=ndev,
            shard_lanes=0,
            submit_s=time.perf_counter() - t0,
            finish_s=0.0,
            # the flush's ONE gather: (4, 20) int32 per shard
            all_gather_bytes=ndev * PARTIAL_BYTES,
            devices=devices,
        )
        return bok

    return run_chunk, finish


def prepare_rlc_shards(pts_bytes, scalars, ndev: int):
    """Host prep for sharded_rlc_check: split lanes into ndev contiguous
    chunks, each with its own window sort and bucket boundaries
    (ops/msm_torch.sort_windows; the Fenwick indices derive on the device).
    pts_bytes (N, 32) uint8, N divisible by ndev; scalars (N, 32) uint8 or
    ints. Returns (pts (D, 32, n), perm (D, T, n), ends (D, T, 256))."""
    n = pts_bytes.shape[0]
    if n % ndev:
        raise ValueError(f"lanes {n} not divisible by mesh size {ndev}")
    per = n // ndev
    t0 = time.perf_counter()
    digits = msm_torch.scalars_to_bytes(scalars, n)
    pts, perms, nodes = [], [], []
    for d in range(ndev):
        sl = slice(d * per, (d + 1) * per)
        perm, ends = msm_torch.sort_windows(digits[sl])
        pts.append(np.ascontiguousarray(pts_bytes[sl].T))
        perms.append(perm)
        nodes.append(ends)
    out = np.stack(pts), np.stack(perms), np.stack(nodes)
    _mesh_tm.record_prepare(ndev, per, time.perf_counter() - t0)
    return out


def split_powers(powers) -> np.ndarray:
    """int64-range voting powers -> uint32[4, ...batch] planes of 16 bits
    each (exact for powers < 2^64; reference powers are int64)."""
    p = np.asarray(powers, dtype=np.uint64)
    planes = np.stack([(p >> np.uint64(16 * k)) & np.uint64(0xFFFF) for k in range(4)])
    return planes.astype(np.uint32)


def shard_batch_arrays(mesh: Mesh, *arrays):
    """Host arrays with the trailing axes sharded over the mesh
    (right-aligned; each array keeps one leading non-batch axis unsharded):
    one ShardedArray an array, its per-shard tensors each on its own
    device, which the runners take as they are."""
    return tuple(_split(mesh, a) for a in arrays)


def aggregate_bitmap_sharded(coords, bitmap, n_shards: Optional[int] = None,
                             mesh: Optional[Mesh] = None):
    """Sharded BLS aggregate-pubkey fold: partition the signer coordinate
    list into contiguous shards, run the bitmap fold of each shard on its
    device (ops/bls12_torch.fold_points_submit: the fp381_mul kernel on a
    card), then combine the per-shard sums with ONE final O(n_shards)
    reduction in bls_ref, as the reference combines them.

    coords: [(x, y)] affine G1 ints; bitmap: per-index booleans. The shards'
    devices are `mesh`'s (its size is the shard count), else every visible
    card, else the CPU, shard s on device s modulo their count; n_shards
    defaults to that count. Returns affine (x, y) ints or None (empty
    selection)."""
    from tendermint_tpu_torch.crypto import bls_ref
    from tendermint_tpu_torch.ops import bls12_torch

    n = len(coords)
    if n != len(bitmap):
        raise ValueError("coords/bitmap length mismatch")
    if mesh is not None:
        devs = mesh.flat
        n_shards = mesh.size
    else:
        devs = _mesh_health._visible_devices() or [torch.device("cpu")]
    if n_shards is None:
        n_shards = len(devs)
    n_shards = max(1, min(n_shards, n or 1))
    per = (n + n_shards - 1) // n_shards
    folds = []
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, n)
        if lo >= n:
            break
        sel = [c for c, b in zip(coords[lo:hi], bitmap[lo:hi]) if b]
        if sel:
            folds.append(bls12_torch.fold_points_submit(
                bls12_torch.affine_limbs(sel), devs[s % len(devs)]))
    acc = bls_ref.G1_IDENTITY
    for pts in folds:
        part = bls12_torch.point_to_affine_int(pts)
        if part is None:
            continue
        acc = bls_ref._jac_add(
            acc,
            (bls_ref._G1Field(part[0]), bls_ref._G1Field(part[1]), bls_ref._G1Field(1)),
        )
    aff = bls_ref._jac_to_affine(acc)
    return None if aff is None else (aff[0].v, aff[1].v)
