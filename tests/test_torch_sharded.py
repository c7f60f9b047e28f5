"""The port's sharded mesh (tendermint_tpu_torch/parallel/sharded.py and the
sharded arms of crypto/batch.py) against the JAX package's, on CPU meshes.

A port mesh may repeat a device: make_mesh([cpu] * 4) is four shards of the
CPU, the torch counterpart of the reference's 8 virtual host devices, and
the runners then run the plain versions of the kernels shard by shard.

- prepare_rlc_shards and split_powers give the reference's bytes;
- the lanes, scalars, window sorts and pad record that the port's
  _verify_batch_rlc_sharded hands its runner are the reference's, captured
  from both packages' arms over one seeded draw of the RLC coefficients;
- each shard's partial point of the real sharded_rlc_check (four shards)
  and sharded_rlc_stream (two, over two chunks) equals, in canonical
  32-byte encoding, the reference's host MSM (`_host_msm`) over that
  shard's lanes;
- verify_batch_cuda on a pinned CPU mesh gives verify_batch_cpu's mask for a
  clean set, a bad signature and a bad encoding, with the reference's labels;
- sharded_verify and sharded_commit_step on 1D and 2D meshes equal the
  single-device ladder and Python-int tallies;
- aggregate_bitmap_sharded equals bls_ref's sum.

Tolerance 0 throughout.
"""

import os

import numpy as np
import pytest
import torch

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

from tendermint_tpu.crypto import batch as ref_batch  # noqa: E402
from tendermint_tpu.crypto import ed25519_ref as ref  # noqa: E402
from tendermint_tpu.crypto.keys import gen_ed25519  # noqa: E402
from tendermint_tpu.parallel import sharded as ref_sharded  # noqa: E402
from tendermint_tpu.parallel import telemetry as ref_tm  # noqa: E402
from tendermint_tpu_torch.crypto import batch  # noqa: E402
from tendermint_tpu_torch.ops import fe25519 as fe  # noqa: E402
from tendermint_tpu_torch.ops import msm_torch  # noqa: E402
from tendermint_tpu_torch.parallel import health, sharded  # noqa: E402
from tendermint_tpu_torch.parallel import telemetry as tm  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
NOT_ON_CURVE = next(y.to_bytes(32, "little") for y in range(2, 100)
                    if ref.point_decompress(y.to_bytes(32, "little")) is None)


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    yield
    batch._MEMO = prev


@pytest.fixture(autouse=True)
def _fresh_mesh_state(monkeypatch):
    """A fresh health model in the port (no probe thread) and the card arm's
    routing (the variable unset)."""
    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)
    hm = health.MeshHealthManager()
    hm._spawn_probe_thread = False
    monkeypatch.setattr(health, "MESH_HEALTH", hm)
    tm.reset()
    yield
    batch.invalidate_sharded_env()
    sharded.set_shard_fault_hook(None)
    tm.reset()


def signed_rows(n: int, tag: int = 1):
    privs = [gen_ed25519(bytes([tag, i % 256, i // 256]) + bytes(29)) for i in range(n)]
    msgs = [b"sharded-row-%d" % i for i in range(n)]
    return ([p.pub_key().bytes() for p in privs], msgs,
            [p.sign(m) for p, m in zip(privs, msgs)])


@pytest.fixture(scope="module")
def rows():
    return signed_rows(2000)


def _flip(sig: bytes) -> bytes:
    s = bytearray(sig)
    s[40] ^= 0x01
    return bytes(s)


def _seed_rlc(monkeypatch, seed: int) -> None:
    """Both packages draw their RLC coefficients from
    np.random.default_rng() with no seed: pin that draw."""
    real = np.random.default_rng

    def seeded(*a, **k):
        return real(*a, **k) if (a or k) else real(seed)

    monkeypatch.setattr(np.random, "default_rng", seeded)


# --------------------------------------------------------------- host prep


@pytest.mark.parametrize("n,nd", [(64, 4), (1024, 8), (3000, 2)])
def test_prepare_rlc_shards_and_split_powers_match(n, nd):
    rng = np.random.default_rng(n)
    pts = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    scalars = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    scalars[:, 31] &= 0x1F
    scalars[rng.random(n) < 0.2] = 0  # zero lanes: bucket 0
    got = sharded.prepare_rlc_shards(pts, scalars, nd)
    want = ref_sharded.prepare_rlc_shards(pts, scalars, nd)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert tm.mesh_stats()["last_prep"]["lanes_per_shard"] == n // nd
    ints = [int(x) for x in rng.integers(0, 1 << 62, size=n)] + [2**64 - 1, 0, 1 << 48]
    g, w = sharded.split_powers(ints), ref_sharded.split_powers(ints)
    assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    with pytest.raises(ValueError):
        sharded.prepare_rlc_shards(pts[:n - 1], scalars[:n - 1], nd)


# ---------------------------------------------------- what the runner gets


class _Capture:
    """A runner that records its arguments and fails the check, so both
    packages' arms stop after one attempt."""

    def __init__(self):
        self.args = None

    def __call__(self, pts, perm, ends):
        self.args = (np.asarray(pts), np.asarray(perm), np.asarray(ends))
        return False, np.ones(pts.shape[0] * pts.shape[2], dtype=bool)


@pytest.mark.parametrize("n,nd", [(100, 4), (1000, 8), (10_000, 8)])
def test_runner_arrays_and_pad_match(monkeypatch, n, nd):
    """The reference's example of the fused round-up: 10k rows on 8 shards
    pad 20,480 -> 24,576 lanes (3 x 1,024 a shard). Precheck rejects and an
    s >= L row ride along. TMTPU_FUSED_MSM=1 makes the reference take the
    fused schedule's rule on its CPU twins, as the port's fused rule is
    always the card's."""
    monkeypatch.setenv("TMTPU_FUSED_MSM", "1")
    rng = np.random.default_rng(n + nd)
    pks = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
    msgs = [b"m%d" % i for i in range(n)]
    sigs = []
    for _ in range(n):
        s = bytearray(rng.integers(0, 256, 64, dtype=np.uint8))
        s[63] &= 0x0F  # s < L
        sigs.append(bytes(s))
    pks[3] = pks[3][:16]
    sigs[5] = sigs[5][:32] + ref.L.to_bytes(32, "little")
    got, want = _Capture(), _Capture()
    monkeypatch.setattr(ref_batch, "_sharded_env", lambda: (nd, None, want, None))
    ref_tm.reset()
    _seed_rlc(monkeypatch, 77)
    assert ref_batch._verify_batch_rlc_sharded(pks, msgs, sigs) is None
    _seed_rlc(monkeypatch, 77)
    assert batch._verify_batch_rlc_sharded(pks, msgs, sigs, (nd, None, got, None)) is None
    for g, w in zip(got.args, want.args):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert tm.mesh_stats()["last_pad"] == ref_tm.mesh_stats()["last_pad"]
    if n == 10_000:
        assert got.args[0].shape == (8, 32, 3 * 1024)
    ref_tm.reset()


# --------------------------------------------------- partial points, exact


def _partial_encoding(p: torch.Tensor) -> bytes:
    x, y, z, t = (fe.to_int(p[k].numpy()) for k in range(4))
    return ref.point_compress((x, y, z, t))


def _host_partial(pts: np.ndarray, perm: np.ndarray, ends: np.ndarray) -> bytes:
    """The reference's host MSM over one shard's lanes: pts (32, n), the
    scalars read back from the shard's window sort."""
    from tests.test_flush_planner import _scalars_from_windows

    sc = _scalars_from_windows(perm, ends)
    pairs = []
    for i in range(pts.shape[1]):
        p = ref.point_decompress(bytes(pts[:, i]))
        if p is not None and sc[i]:
            pairs.append((p, sc[i]))
    total = ref_batch._host_msm(pairs)
    return ref.point_compress(ref.IDENTITY if total is None else total)


def _lanes(monkeypatch, rows, n: int, na: int):
    pks, msgs, sigs = (x[:n] for x in rows)
    sigs = list(sigs)
    sigs[1] = _flip(sigs[1])  # the partials are exact whatever the verdict
    precheck, a_rows, r_rows, s_rows, h_rows = batch._precheck_and_hash_fast(pks, msgs, sigs)
    _seed_rlc(monkeypatch, 5)
    return batch._rlc_layout(precheck, a_rows, r_rows, s_rows, h_rows, na)


def test_sharded_rlc_check_partials_equal_host_msm(monkeypatch, rows):
    """2,000 rows on make_mesh([cpu] * 4): 1,024 lanes a shard, the fused
    schedule; each shard's partial point as the reference's host MSM."""
    pts, scalars = _lanes(monkeypatch, rows, 2000, 2048)
    mesh = sharded.make_mesh([CPU] * 4)
    assert mesh.keys == ["cpu#0", "cpu#1", "cpu#2", "cpu#3"]
    shards = sharded.prepare_rlc_shards(pts, scalars, 4)
    assert msm_torch.fused_for_lanes(shards[0].shape[2])
    seen = []
    real = sharded._gather_fold

    def capture(mesh_, parts):
        seen.extend(p.clone() for p in parts)
        return real(mesh_, parts)

    monkeypatch.setattr(sharded, "_gather_fold", capture)
    bok, ok = sharded.sharded_rlc_check(mesh)(*shards)
    assert bok is False  # the flipped row
    assert ok.shape == (4096,) and ok.all()
    assert [_partial_encoding(p) for p in seen] == [
        _host_partial(*(x[d] for x in shards)) for d in range(4)]
    lf = tm.mesh_stats()["last_flush"]
    assert (lf["kind"], lf["shards"], lf["lanes_per_shard"], lf["all_gather_bytes"]) == (
        "rlc", 4, 1024, 4 * 4 * 20 * 4)


def test_sharded_rlc_stream_partials_accumulate(monkeypatch, rows):
    """Two chunks of 100 rows on make_mesh([cpu] * 2), 1,024 lanes a shard
    (the fused schedule; sharded_rlc_check's test runs four shards): after
    each run_chunk every shard's accumulator is the reference's host MSM
    over its lanes so far; finish gives the verdict of their sum."""
    mesh = sharded.make_mesh([CPU] * 2)
    run_chunk, finish = sharded.sharded_rlc_stream(mesh)
    acc, host = None, [None] * 2
    for lo in (0, 100):
        pts, scalars = _lanes(monkeypatch, tuple(x[lo:] for x in rows), 100, 1024)
        shards = sharded.prepare_rlc_shards(pts, scalars, 2)
        acc, flags = run_chunk(*shards, acc)
        assert np.asarray(flags).shape == (2, 1024)
        for d in range(2):
            part = ref.point_decompress(_host_partial(*(x[d] for x in shards)))
            host[d] = part if host[d] is None else ref.point_add(host[d], part)
        assert [_partial_encoding(a) for a in acc] == [ref.point_compress(h) for h in host]
    total = ref.point_add(host[0], host[1])
    assert bool(finish(acc).item()) == ref.point_equal(total, ref.IDENTITY)
    assert tm.mesh_stats()["flushes"] == {"rlc_stream_chunk": 2, "rlc_stream_finish": 1}
    assert tm.mesh_stats()["totals"]["all_gather_bytes"] == 2 * 4 * 20 * 4


# ------------------------------------------------ verdicts through routing


@pytest.mark.parametrize("case", ["clean", "bad_signature", "bad_encoding"])
def test_pinned_cpu_mesh_masks_equal_host(monkeypatch, rows, case):
    """verify_batch_cuda on a pinned CPU mesh env (make_mesh([cpu] * 4) for
    the clean set, [cpu] * 2 for the others, whose ladders cost a pass a
    shard): a clean set passes the sharded combined check
    ("rlc-sharded"); a bad signature or an R that is not on the curve fails
    it and the sharded ladder recovers the exact mask ("sharded", one leaf),
    as the reference labels them."""
    monkeypatch.setattr(batch, "RLC_MIN", 32)
    pks, msgs, sigs = (list(x[:96]) for x in rows)
    if case == "bad_signature":
        sigs[17] = _flip(sigs[17])
    elif case == "bad_encoding":
        sigs[40] = NOT_ON_CURVE + sigs[40][32:]
    nd = 4 if case == "clean" else 2
    env = batch._build_sharded_env([CPU] * nd)
    monkeypatch.setattr(batch, "_sharded_env", lambda: env)
    mask = batch.verify_batch_cuda(pks, msgs, sigs, CPU)
    want = ref_batch.verify_batch_cpu(pks, msgs, sigs)
    assert mask.tobytes() == want.tobytes()
    if case == "clean":
        assert mask.all() and batch._PATH.label == "rlc-sharded"
        f = batch.LAST_FLUSH
        assert (f["mode"], f["shards"], f["lanes"]) == ("sharded", 4, 512)
    else:
        assert int((~mask).sum()) == 1 and batch._PATH.label == "sharded"
        assert batch.LAST_FLUSH["recovery_flushes"] == 1
    assert tm.mesh_stats()["last_pad"]["requested_lanes"] == 2 * 96 + 1


def test_card_mesh_never_meets_a_cpu_flush(monkeypatch):
    """A mesh of cards (its platform "cuda") is not consulted for a cpu
    flush; TMTPU_SHARDED=0 turns the mesh off; with no card no mesh is
    built."""
    fake = batch.MeshEnv(2, None, None, None, type("M", (), {"platform": "cuda"})())
    monkeypatch.setattr(batch, "_sharded_env", lambda: fake)
    assert batch._mesh_env(CPU) is None
    assert batch._mesh_env(torch.device("cuda", 0)) is fake
    monkeypatch.undo()
    monkeypatch.setenv("TMTPU_SHARDED", "0")
    assert batch._sharded_env() is None
    monkeypatch.setenv("TMTPU_SHARDED", "auto")
    assert batch._sharded_env() is None  # no card here
    assert batch.mesh_ladder_state() == "single"


# ------------------------------------------- the ladder and the tallies


def _ladder_inputs(rows, n: int):
    pks, msgs, sigs = (list(x[:n]) for x in rows)
    sigs[3] = _flip(sigs[3])
    pks[n - 1] = NOT_ON_CURVE
    a, r, s_d, h_d, precheck, m = batch.prepare_batch(pks, msgs, sigs)
    return a[:, :n], r[:, :n], s_d[:, :n], h_d[:, :n]


@pytest.fixture(scope="module")
def ladder16(rows):
    """16 rows (a bad signature, an undecodable key) and the single-device
    ladder's mask over them."""
    from tendermint_tpu_torch.ops.ed25519_torch import verify_prepared

    ins = _ladder_inputs(rows, 16)
    single = verify_prepared(*(torch.from_numpy(x) for x in ins)).numpy()
    assert int(single.sum()) == 14
    return ins, single


@pytest.mark.parametrize("shape,axes,arm", [
    ((2,), ("vals",), "verify"), ((2, 2), ("blocks", "vals"), "verify"),
    ((2,), ("vals",), "commit"), ((2, 2), ("blocks", "vals"), "commit")])
def test_sharded_verify_and_commit_step_match(ladder16, shape, axes, arm):
    """On a 1D mesh of 2 and a 2D 2 x 2 mesh ([4, 4] batch): the mask
    equals the single-device ladder's; the commit step accepts the honest
    powers on the 1D mesh and refuses on the 2D mesh a set whose bad rows
    hold a third of the power, as Python-int tallies decide."""
    ins, single = ladder16
    mesh = sharded.make_mesh([CPU] * int(np.prod(shape)), shape=shape, axis_names=axes)
    batch_shape = (16,) if len(shape) == 1 else (4, 4)
    ins = [x.reshape(x.shape[0], *batch_shape) for x in ins]
    if arm == "verify":
        mask = sharded.sharded_verify(mesh)(*sharded.shard_batch_arrays(mesh, *ins))
        kind = "persig"
    else:
        powers = [(1 << 40) + 7 * i for i in range(16)]
        if len(shape) == 2:
            powers = [p if v else p * 100 for p, v in zip(powers, single)]
        talled = sum(p for p, v in zip(powers, single) if v)
        planes = sharded.split_powers(powers).reshape(4, *batch_shape)
        mask, ok = sharded.sharded_commit_step(mesh)(*ins, planes)
        assert ok is (talled * 3 > sum(powers) * 2) and ok is (len(shape) == 1)
        kind = "commit_step"
    assert mask.shape == batch_shape and mask.reshape(-1).tolist() == single.tolist()
    assert tm.mesh_stats()["flushes"] == {kind: 1}


def test_sharded_verify_pads_a_short_batch(rows):
    """A per-signature flush of a lane count the shards do not divide (a
    bisection leaf) pads with zero lanes and trims them."""
    a, r, s_d, h_d = _ladder_inputs(rows, 5)
    mask = sharded.sharded_verify(sharded.make_mesh([CPU] * 2))(a, r, s_d, h_d)
    assert mask.tolist() == [True, True, True, False, False]


def test_aggregate_bitmap_sharded_equals_bls_ref():
    from tendermint_tpu_torch.crypto import bls_ref as B

    pts, acc = [], B.G1_IDENTITY
    bitmap = [i % 3 != 1 for i in range(13)]
    pt = B._jac_mul(B.G1_GEN, 12345)
    for i in range(13):
        x, y = B._jac_to_affine(pt)
        pts.append((x.v, y.v))
        if bitmap[i]:
            acc = B._jac_add(acc, pt)
        pt = B._jac_add(pt, B.G1_GEN)
    want = B._jac_to_affine(acc)
    mesh = sharded.make_mesh([CPU] * 4)
    assert sharded.aggregate_bitmap_sharded(pts, bitmap, mesh=mesh) == (want[0].v, want[1].v)
    assert sharded.aggregate_bitmap_sharded(pts, bitmap, n_shards=3) == (want[0].v, want[1].v)
    assert sharded.aggregate_bitmap_sharded(pts, [False] * 13, mesh=mesh) is None
    with pytest.raises(ValueError):
        sharded.aggregate_bitmap_sharded(pts, bitmap[:5])
