"""The port's profiler capture (libs/profiler.py, on torch.profiler) and its
report (tools/profile_report.py), on the CPU.

- A hand-written chrome trace in torch's layout, holding the port's kernel
  names, the record_function ranges "decompress", "msm" and "persig"
  (host user_annotation events and a device gpu_user_annotation span), the
  runtime and driver launches that correlation ids join to their kernels,
  torch's own kernels, a memcpy and a memset: every device event lands in
  its expected stage, the innermost range wins, and the stage table, the
  range table and the unattributed share are exact.
- A capture taken on the CPU around a small flush (a host-arm verify_batch
  and an R decompression in its "decompress" range): one session at a
  time (a second start, and a start inside another torch.profiler session,
  raise ProfilerError), the run directory and its gzipped chrome trace,
  status(), and the report's host stages; the command line writes the
  markdown table and the JSON.

Tolerance: zero (stages, counts and microseconds of the fixture).
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.libs import profiler
from tendermint_tpu_torch.ops import msm_torch
from tendermint_tpu_torch.tools import profile_report as pr
from tests.torch_routing_util import signed_rows

CPU, DEV = (100, 1), (0, 7)  # (pid, tid) of the host thread and the card's stream


def _x(cat, name, where, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": where[0], "tid": where[1], "ts": ts,
         "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def fixture_trace():
    """(the trace, [(kernel name, correlation, ts, dur, expected stage)])."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 100, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
        _x("Trace", "PyTorch Profiler (0)", CPU, 0, 10_000),
        _x("user_annotation", "decompress", CPU, 1000, 200),
        _x("cuda_runtime", "cudaLaunchKernel", CPU, 1010, 5, corr=1),
        _x("cpu_op", "aten::add", CPU, 1020, 30),
        _x("cuda_runtime", "cudaLaunchKernel", CPU, 1030, 5, corr=2),
        _x("user_annotation", "msm", CPU, 1300, 400),
        _x("cuda_runtime", "cudaLaunchKernel", CPU, 1310, 5, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", CPU, 1320, 5, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", CPU, 1330, 5, corr=5),
        _x("cuda_runtime", "cudaLaunchKernel", CPU, 1340, 5, corr=6),
        _x("user_annotation", "decompress", CPU, 1400, 50),  # nested: the innermost wins
        _x("cuda_runtime", "cudaLaunchKernel", CPU, 1410, 5, corr=7),
        _x("cuda_runtime", "cudaLaunchKernel", CPU, 1500, 5, corr=8),
        _x("cuda_runtime", "cudaMemcpyAsync", CPU, 1600, 5, corr=9),
        _x("user_annotation", "persig", CPU, 2000, 300),
        _x("cuda_driver", "cuLaunchKernel", CPU, 2010, 5, corr=10),
        _x("cuda_runtime", "cudaLaunchKernel", CPU, 3000, 5, corr=12),  # in no range
        _x("gpu_user_annotation", "persig", DEV, 5000, 100),
    ]
    kernels = [  # (name, corr, ts, dur, expected stage)
        ("fsquare_chain_quad_kernel(int*, int const*, long, int)", 1, 1100, 17, "decompress"),
        ("void at::native::vectorized_elementwise_kernel<4, add>(int)", 2, 1120, 3, "glue"),
        ("uptree_kernel(int const*, unsigned short const*, int*, long, int)", 3, 1400, 680,
         "uptree"),
        ("fenwick_kernel(int const*, int const*, int*, long)", 4, 2100, 145, "fenwick_reduce"),
        ("bucket_fold_kernel(int const*, int*, int)", 5, 2300, 35, "bucket_fold"),
        ("padd_lanes_kernel(int const*, int const*, int*, long)", 6, 2400, 3, "msm"),
        ("pdbl_lanes_kernel(int const*, int*, long, int)", 7, 2500, 11, "decompress"),
        ("pdbl_lanes_kernel(int const*, int*, long, int)", 8, 2600, 12, "msm"),
        ("Memcpy HtoD (Pageable -> Device)", 9, 2700, 20, "transfer"),
        ("padd_quad_kernel(int const*, int const*, int*, long)", 10, 4000, 15, "persig"),
        ("fp381_mul_few_kernel(int const*, int const*, int*, long, long)", 11, 4100, 2, "bls"),
        ("fsquare_chain_kernel(int*, int const*, long, int)", 99, 5010, 29, "persig"),
        ("pdbl_quad_kernel(int const*, int*, long, int)", 12, 6000, 27, "other"),
        ("Memset (Device)", 13, 6100, 1, "glue"),
    ]
    for name, corr, ts, dur, _ in kernels:
        cat = "gpu_memcpy" if name.startswith("Memcpy") else (
            "gpu_memset" if name.startswith("Memset") else "kernel")
        ev.append(_x(cat, name, DEV, ts, dur, corr=corr))
    return {"traceEvents": ev}, kernels


def test_classify_names():
    assert pr.classify("uptree_kernel(int const*)") == "uptree"
    assert pr.classify("fenwick_kernel(int)") == "fenwick_reduce"
    assert pr.classify("bucket_fold_kernel(int)") == "bucket_fold"
    assert pr.classify("fp12_sparse_mul_kernel(int)") == "bls"
    assert pr.classify("void at::native::index_elementwise_kernel<128, 4>") == "glue"
    assert pr.classify("Memcpy DtoH (Device -> Pinned)") == "transfer"
    assert pr.classify("compile:point_kernels") == "compile"
    assert pr.classify("cudaLaunchKernel") == pr.classify("cuLaunchKernel") == "dispatch"
    assert pr.classify("aten::index_select") == "host_ops"
    for rng in ("decompress", "msm", "persig"):
        assert pr.classify(rng) == rng
    assert pr.classify("padd_lanes_kernel(int)") == "other"


def test_fixture_trace_stages_ranges_and_shares(tmp_path):
    trace, kernels = fixture_trace()
    path = tmp_path / "cap" / "host.trace.json.gz"
    path.parent.mkdir()
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)
    assert pr.find_capture_files(str(tmp_path)) == [str(path)]
    events = pr.load_events(str(path))
    launches, host, dev = pr._ranges(events)
    for name, corr, ts, dur, want in kernels:
        e = next(x for x in events if x["cat"] != "cuda_runtime" and x["correlation"] == corr)
        assert pr.device_stage(e, launches, host, dev)[0] == want, name
    rep = pr.report(str(tmp_path))
    want: dict = {}
    for name, corr, ts, dur, stage in kernels:
        c, us = want.get(stage, (0, 0.0))
        want[stage] = (c + 1, us + dur)
    got = {s["name"]: (s["count"], s["device_us"]) for s in rep["stages"]}
    assert got == want
    busy = sum(k[3] for k in kernels)
    assert rep["device_busy_ms"] == round(busy / 1e3, 3)
    assert rep["unattributed_share"] == round(27 / busy, 4)
    ranges = {r["name"]: (r["count"], r["device_us"], r["glue_us"]) for r in rep["ranges"]}
    assert ranges == {"decompress": (3, 31.0, 3.0), "msm": (6, 895.0, 0.0),
                      "persig": (2, 44.0, 0.0)}
    host = {s["name"]: s["count"] for s in rep["host_stages"]}
    assert host == {"decompress": 2, "msm": 1, "persig": 1, "dispatch": 10, "transfer": 1,
                    "host_ops": 1}
    assert all("PyTorch Profiler" not in o["name"] for o in rep["ops"])
    md = pr.render_markdown(rep)
    assert "| uptree | 1 | 0.680 |" in md and "2.7% fell to no stage" in md


def test_capture_on_the_cpu_and_report(tmp_path, capsys):
    pks, msgs, sigs = signed_rows(64)
    rows = np.frombuffer(b"".join(s[:32] for s in sigs[:2]), dtype=np.uint8).reshape(2, 32)

    def flush():
        mask = tbatch.verify_batch(pks, msgs, sigs, device="cpu", backend="cpu")
        pts, ok = msm_torch.decompress_rows(rows, "cpu")
        return mask, ok

    (mask, ok), run_dir = profiler.trace_function(flush, base_dir=str(tmp_path))
    assert mask.all() and bool(ok.all())
    assert os.path.basename(run_dir).startswith("tmtpu_profile_")
    assert os.listdir(run_dir) == [profiler.TRACE_FILE]
    st = profiler.status()
    assert st["active"] is False and st["last_capture"]["dir"] == run_dir
    assert st["last_capture"]["artifacts"][0]["file"] == profiler.TRACE_FILE
    rep = pr.report(run_dir, top=5)
    assert rep["device_busy_ms"] == 0 and rep["stages"] == []
    host = {s["name"] for s in rep["host_stages"]}
    assert {"decompress", "host_ops"} <= host and len(rep["ops"]) == 5
    out_json = tmp_path / "rep.json"
    assert pr.main([run_dir, "--top", "3", "--json", str(out_json)]) == 0
    assert "## Host self time by stage" in capsys.readouterr().out
    assert json.loads(out_json.read_text())["events"] == rep["events"]
    assert pr.main([str(tmp_path / "nothing-here")]) == 2


def test_one_session_at_a_time(tmp_path):
    info = profiler.start(str(tmp_path))
    try:
        assert profiler.status()["active"] and profiler.status()["dir"] == info["dir"]
        with pytest.raises(profiler.ProfilerError, match="already active"):
            profiler.start(str(tmp_path))
    finally:
        profiler.stop()
    with pytest.raises(profiler.ProfilerError, match="no profiler capture"):
        profiler.stop()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(profiler.ProfilerError, match="another torch.profiler"):
            profiler.start(str(tmp_path))
    assert not profiler.status()["active"]
    second = profiler.trace_function(torch.zeros, 3, base_dir=str(tmp_path))[1]
    assert second != info["dir"] and os.path.isdir(second)
