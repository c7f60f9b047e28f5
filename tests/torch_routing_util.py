"""Shared inputs and knobs of the port's routing tests
(tests/test_torch_host_routing.py, test_torch_pipelined.py,
test_torch_bisect.py, test_torch_rlc_mixed.py).

Seeded rows with the edge inputs, the same knobs set in both packages, and
one comparison: the port's verify_batch (device="cpu", the kernels' plain
versions) against the JAX package, whose mask comes from its host path
(verify_batch(backend="cpu")) and whose route label and recovery flush
count come from its own routing (_verify_batch_routed) run under its host
twins (tests/test_flush_planner._install_host_twins), with its verified-row
memo off. Tolerance: zero.
"""

import numpy as np
import pytest

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import keys as tkeys
from tests.sigutil import torsion_defect_sig
from tests.test_flush_planner import _install_host_twins

_REF_FILL_A_CACHE = jbatch._fill_a_cache  # the twins below make it a no-op

NOT_ON_CURVE = next(y.to_bytes(32, "little") for y in range(2, 100)
                    if ref.point_decompress(y.to_bytes(32, "little")) is None)

_SIGNED: dict = {}


def signed_rows(n: int, seed: int = 1):
    """n honest rows of distinct seeded keys, as lists."""
    if len(_SIGNED.get(seed, ((),))[0]) < n:
        privs = [jkeys.gen_ed25519(bytes([0x5A, seed, i % 256, i // 256]) + bytes(28))
                 for i in range(n)]
        msgs = [b"route-%d-%d" % (seed, i) for i in range(n)]
        _SIGNED[seed] = ([p.pub_key().bytes() for p in privs], msgs,
                         [p.sign(m) for p, m in zip(privs, msgs)])
    return tuple(list(x[:n]) for x in _SIGNED[seed])


def flip(sig: bytes) -> bytes:
    """Valid encodings, wrong s: only the curve equation fails."""
    return sig[:32] + (1).to_bytes(32, "little")


def rows_with(n: int, bad=(), edges: bool = False, encodings: bool = True, seed: int = 1):
    """signed_rows(n) with wrong signatures at `bad` and, with `edges`, an
    s >= L (row 1), a short key (row 5), a torsion-defect row (row 7,
    accepted cofactored, refused cofactorless) and, with `encodings`, an A
    off the curve (row 2) and a non-canonical R (row 4). The precheck
    refuses rows 1 and 5 before any combined check; rows 2 and 4 fail one."""
    pks, msgs, sigs = signed_rows(n, seed)
    for i in bad:
        sigs[i] = flip(sigs[i])
    if edges:
        s = int.from_bytes(sigs[1][32:], "little")
        sigs[1] = sigs[1][:32] + (s + ref.L).to_bytes(32, "little")
        pks[5] = pks[5][:31]
        pks[7], msgs[7], sigs[7] = torsion_defect_sig(msg=b"route-torsion")
        if encodings:
            pks[2] = NOT_ON_CURVE
            sigs[4] = ref.P.to_bytes(32, "little") + sigs[4][32:]
    return pks, msgs, sigs


class Knobs:
    """Sets one knob in both packages at once; the fixture restores them."""

    def prep(self, **kw):
        tbatch.configure_prep(**kw)
        jbatch.configure_prep(**kw)

    def planner(self, max_flush_lanes: int):
        tbatch.configure_planner(max_flush_lanes=max_flush_lanes)
        jbatch.configure_planner(max_flush_lanes=max_flush_lanes)

    def mode(self, mode: str):
        tkeys.set_verify_mode(mode)
        jkeys.set_verify_mode(mode)


@pytest.fixture
def knobs(monkeypatch):
    """Both packages' prep config, planner budget, RLC_MIN, _HOST_RLC_MIN
    and verify mode are restored after the test; the reference's default
    backend is its card arm ("jax", run by its host twins) and its memo is
    off; the A caches start empty."""
    prep = (dict(tbatch._PREP_CFG), dict(jbatch._PREP_CFG))
    budget = (tbatch.planner_budget(), jbatch.planner_budget())
    for mod in (tbatch, jbatch):
        monkeypatch.setattr(mod, "RLC_MIN", mod.RLC_MIN)
        monkeypatch.setattr(mod, "_HOST_RLC_MIN", mod._HOST_RLC_MIN)
    for k in (tkeys, jkeys):
        monkeypatch.setattr(k, "_VERIFY_MODE", k._VERIFY_MODE)
    monkeypatch.setenv("TMTPU_CRYPTO_BACKEND", "jax")
    for name in ("TMTPU_BISECT", "TMTPU_BISECT_LEAF", "TMTPU_BISECT_MAX_BAD"):
        monkeypatch.delenv(name, raising=False)
    _install_host_twins(monkeypatch)
    jbatch.configure_verified_memo(0)
    tbatch.reset_a_cache()
    yield Knobs()
    tbatch.reset_a_cache()
    jbatch.configure_verified_memo(jbatch._memo_env_rows())
    for mod, cfg, b in ((tbatch, prep[0], budget[0]), (jbatch, prep[1], budget[1])):
        mod._PREP_CFG.clear()
        mod._PREP_CFG.update(cfg)
        mod.configure_planner(max_flush_lanes=b)


def reference(pks, msgs, sigs, backend=None):
    """The JAX package on the same rows: (host-path mask, route label,
    recovery flushes or None)."""
    want = jbatch.verify_batch(pks, msgs, sigs, backend="cpu")
    jbatch.LAST_FLUSH_DETAIL.clear()
    jb = {None: None, "cpu": "cpu", "cuda": "jax"}[backend]
    twin_mask, _, path = jbatch._verify_batch_routed(pks, msgs, sigs, jb, None)
    assert np.asarray(twin_mask).tobytes() == want.tobytes()
    return want, path, jbatch.LAST_FLUSH_DETAIL.get("recovery_flushes")


def check(pks, msgs, sigs, backend=None) -> dict:
    """The port against the reference: masks byte-identical, route labels
    and recovery flush counts equal. Returns the port's LAST_FLUSH with the
    mask under "mask"."""
    got = tbatch.verify_batch(pks, msgs, sigs, device="cpu", backend=backend)
    flush = dict(tbatch.LAST_FLUSH)
    want, path, flushes = reference(pks, msgs, sigs, backend)
    assert got.dtype == np.bool_ and got.tobytes() == want.tobytes()
    assert flush["path"] == path
    assert flush.get("recovery_flushes") == flushes
    flush["mask"] = got
    return flush


# ---------------------------------------------------------------------------
# The reference's mixed flush on host twins. Its one-MSM mixed route decodes
# keys into its typed A cache (msm_jax.decompress_rows, ristretto_jax.
# decode_rows) and runs msm_jax.rlc_check_cached_mixed_submit; its Ed25519
# cached flush (the split's Ed25519 rows, once their keys are cached) runs
# msm_jax.rlc_check_cached_submit. Each twin computes the same function on
# host points: ed25519_ref decompression, the host ristretto255 decode and
# the host Pippenger MSM (batch._host_msm), so no JAX kernel is compiled.


def _limb_int(col) -> int:
    return sum(int(v) << (13 * i) for i, v in enumerate(np.asarray(col).astype(np.int64))) % ref.P


def _coords_of(points):
    """[extended point or None] -> ((x, y, z, t) each (20, m) int32, ok (m,))."""
    from tendermint_tpu.ops import fe25519 as jfe

    m = len(points)
    coords = tuple(np.zeros((20, m), dtype=np.int32) for _ in range(4))
    ok = np.zeros(m, dtype=bool)
    for j, pt in enumerate(points):
        if pt is not None:
            ok[j] = True
            for c in range(4):
                coords[c][:, j] = jfe.from_int(pt[c] % ref.P)
    return coords, ok


def _scalar_ints(scalars) -> list:
    if isinstance(scalars, np.ndarray):
        return [int.from_bytes(bytes(row), "little") for row in scalars]
    return [int(s) for s in scalars]


def _host_check(points, scalars) -> bool:
    """sum [s_i] P_i == identity over the lanes with a point, as the kernels
    decide it (an all-zero Z reads as failed)."""
    pairs = [(p, s) for p, s in zip(points, scalars) if p is not None and s]
    total = jbatch._host_msm(pairs) or ref.IDENTITY
    return bool(total[2] % ref.P != 0 and ref.point_equal(total, ref.IDENTITY))


def install_mixed_twins(monkeypatch) -> None:
    """Host twins of the reference's mixed flush and its cached Ed25519
    flush, its real _fill_a_cache over twin decoders, and fresh A-cache
    globals (restored after the test, so no other test's reference flush
    sees keys cached here). Use after the knobs fixture."""
    from tendermint_tpu.crypto import sr25519 as jsr
    from tendermint_tpu.ops import msm_jax, ristretto_jax

    def a_points(a_coords):
        cols = [np.asarray(c) for c in a_coords]
        return [tuple(_limb_int(cols[c][:, j]) for c in range(4)) for j in range(cols[0].shape[-1])]

    def decompress_rows(rows):
        return _coords_of([ref.point_decompress(bytes(r)) for r in rows])

    def decode_rows(rows):
        return _coords_of([jsr.ristretto_decode(bytes(r)) for r in rows])

    def cached_submit(a_coords, r_bytes, scalars, presorted=None):
        r = [ref.point_decompress(bytes(x)) for x in r_bytes]
        bok = _host_check(a_points(a_coords) + r, _scalar_ints(scalars))
        return np.concatenate([[bok], [p is not None for p in r]])

    def mixed_submit(a_coords, ed_r_bytes, sr_r_bytes, scalars):
        er = [ref.point_decompress(bytes(x)) for x in ed_r_bytes]
        sr = [jsr.ristretto_decode(bytes(x)) for x in sr_r_bytes]
        bok = _host_check(a_points(a_coords) + er + sr, _scalar_ints(scalars))
        return np.concatenate([[bok], [p is not None for p in er + sr]])

    monkeypatch.setattr(msm_jax, "decompress_rows", decompress_rows)
    monkeypatch.setattr(ristretto_jax, "decode_rows", decode_rows)
    monkeypatch.setattr(msm_jax, "rlc_check_cached_submit", cached_submit)
    monkeypatch.setattr(msm_jax, "rlc_check_cached_mixed_submit", mixed_submit)
    monkeypatch.setattr(jbatch, "_fill_a_cache", _REF_FILL_A_CACHE)
    monkeypatch.setattr(jbatch, "_A_CACHE", {})
    monkeypatch.setattr(jbatch, "_A_STORE", np.empty((4, 20, 1024), dtype=np.int32))
    monkeypatch.setattr(jbatch, "_A_STORE_LEN", 0)
    monkeypatch.setattr(jbatch, "_DEV_A_CACHE", {})
