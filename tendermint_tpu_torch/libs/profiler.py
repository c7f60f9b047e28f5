"""On-demand device profiler capture: a thin torch.profiler session wrapper.
The port's copy of tendermint_tpu/libs/profiler.py.

- `start(base_dir)` / `stop()`: one capture of everything the process runs
  between them (host ops, the CUDA runtime calls, and on a card every
  kernel, copy and memset with its stream and correlation id);
- `status()`: the session's state, safe at any time;
- `trace_function(fn, *args)`: one call captured, with the card synced
  before the capture ends so its kernels land inside.

A capture session is process-global: one at a time, and a `start` while
any torch.profiler session is live (this module's or another's, such as
chip_smoke.py's own timing sessions) raises ProfilerError, so two sessions
never nest. Each capture writes into a fresh run directory
`<base>/tmtpu_profile_<utcstamp>_<pid>_<seq>/`, where `stop` exports the
chrome trace as `torch.trace.json.gz`. tools/profile_report.py turns it
into the per-stage table: the kernels by name (uptree, fenwick_reduce,
bucket_fold, bls), the point kernels by the record_function range they
were launched in (ops/msm_torch.py's "decompress" and "msm",
crypto/batch.py's "persig"), the plain torch ops' kernels as glue.

On the CPU the capture holds host events only: stage attribution of
device time needs the card. The capture and report pipeline is the same.
"""

from __future__ import annotations

import glob
import gzip
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional

TRACE_FILE = "torch.trace.json.gz"

# The record_function ranges that mark the port's stages. The point kernels
# (padd, pdbl, fsquare_chain) launch in all three, so a kernel's stage is the
# range around its launch. A range's device span (gpu_user_annotation)
# covers the kernels launched in it, so it is no kernel of its own.
DECOMPRESS, MSM, PERSIG = "decompress", "msm", "persig"
PROFILE_RANGES = (DECOMPRESS, MSM, PERSIG)


def is_device_record(e) -> bool:
    """A torch.profiler event (or key_averages row) that is device work:
    a kernel, copy or memset, not a range's span."""
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.key not in PROFILE_RANGES)


def device_rows(prof) -> list:
    """A torch.profiler session's device records by name, the ranges'
    spans left out."""
    return [e for e in prof.key_averages() if is_device_record(e)]


class ProfilerError(RuntimeError):
    """start while a session is live, stop when none is, or a profiler
    failure."""


_LOCK = threading.Lock()
_STATE: Dict[str, Any] = {
    "active": False,
    "dir": None,
    "started_at": None,
    "last_capture": None,  # {"dir", "started_at", "stopped_at", "artifacts"}
}
_PROF: list = [None]  # the live torch.profiler.profile
_RUN_SEQ = 0  # uniquifies run dirs within one wall-clock second


def default_base_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "tmtpu_profiles")


def _artifacts(run_dir: str) -> list:
    """Capture artifacts under a run dir: relative paths and sizes."""
    out = []
    for p in sorted(glob.glob(os.path.join(run_dir, "**", "*.trace.json*"), recursive=True)):
        try:
            size = os.path.getsize(p)
        except OSError:
            size = None
        out.append({"file": os.path.relpath(p, run_dir), "bytes": size})
    return out


def _card() -> bool:
    import torch

    return torch.cuda.is_available()


def start(base_dir: Optional[str] = None) -> dict:
    """Begin a capture into a fresh run directory; returns {"dir", ...}.
    Raises ProfilerError while any torch.profiler session is live."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    global _RUN_SEQ
    with _LOCK:
        if _STATE["active"]:
            raise ProfilerError(f"profiler capture already active (dir={_STATE['dir']})")
        if torch._C._autograd._profiler_enabled():
            raise ProfilerError("another torch.profiler session is live")
        _RUN_SEQ += 1
        run_dir = os.path.join(
            base_dir or default_base_dir(),
            time.strftime("tmtpu_profile_%Y%m%d_%H%M%S", time.gmtime())
            + f"_{os.getpid()}_{_RUN_SEQ}")
        os.makedirs(run_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if _card() else [])
        prof = profile(activities=activities)
        try:
            prof.start()
        except Exception as e:
            raise ProfilerError(f"torch.profiler start failed: {e!r}") from e
        _PROF[0] = prof
        _STATE.update(active=True, dir=run_dir, started_at=time.time())
    from tendermint_tpu_torch.libs.trace import tracer

    if tracer.enabled:
        tracer.event("profiler.start", dir=run_dir)
    return {"active": True, "dir": run_dir, "backend": "cuda" if _card() else "cpu"}


def stop() -> dict:
    """End the capture and write its chrome trace; returns {"dir",
    "artifacts", "duration_s"}. Raises ProfilerError when none is active.
    The export runs outside the lock, so status() never waits on it; the
    "stopping" phase keeps start() refused meanwhile."""
    with _LOCK:
        if not _STATE["active"] or _STATE.get("stopping"):
            raise ProfilerError("no profiler capture active")
        run_dir, started, prof = _STATE["dir"], _STATE["started_at"], _PROF[0]
        _STATE["stopping"] = True
    try:
        prof.stop()
        raw = os.path.join(run_dir, "torch.trace.json")
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, gzip.open(os.path.join(run_dir, TRACE_FILE), "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.unlink(raw)
    finally:
        with _LOCK:  # even a failed stop leaves no session to stop again
            _PROF[0] = None
            _STATE.update(active=False, dir=None, started_at=None, stopping=False)
    cap = {"dir": run_dir, "started_at": started, "stopped_at": time.time(),
           "artifacts": _artifacts(run_dir)}
    with _LOCK:
        _STATE["last_capture"] = cap
    from tendermint_tpu_torch.libs.trace import tracer

    if tracer.enabled:
        tracer.event("profiler.stop", dir=run_dir, artifacts=len(cap["artifacts"]))
    return {"active": False, "dir": run_dir,
            "duration_s": round(cap["stopped_at"] - started, 3) if started else None,
            "artifacts": cap["artifacts"]}


def status() -> dict:
    """The session's state; never raises."""
    with _LOCK:
        st = {
            "active": _STATE["active"],
            "stopping": bool(_STATE.get("stopping")),
            "dir": _STATE["dir"],
            "started_at": _STATE["started_at"],
            "last_capture": _STATE["last_capture"],
        }
    if st["active"] and st["started_at"]:
        st["running_s"] = round(time.time() - st["started_at"], 3)
    try:
        st["backend"] = "cuda" if _card() else "cpu"
    except Exception as e:
        st["backend"] = None
        st["error"] = repr(e)
    return st


def trace_function(fn, *args, base_dir: Optional[str] = None, **kwargs):
    """One call captured: start, fn(*args, **kwargs), the card synced,
    stop. Returns (result, run_dir)."""
    import torch

    info = start(base_dir)
    try:
        out = fn(*args, **kwargs)
        if _card() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        stop()
    return out, info["dir"]
