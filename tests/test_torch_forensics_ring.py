"""The heartbeat ring under in-process nodes (tendermint_tpu_torch/libs/
forensics.py) against the JAX package's.

The ring is process-global: each Node that names a forensics directory
configures its own ring, closing the one before. A thread already inside
`beat` with the old ring (a prewarm or a flush of another node) then wrote
into a closed mmap and raised TypeError inside the device entry point
(seen on the card in the 7-node fleet: node 0's prewarm failed). The port
drops a beat on a retired ring; the reference's writer raises (ROADMAP C).
The beats that land are the reference's bytes. No tolerance applies.
"""

import threading
import time

import pytest

from tendermint_tpu.libs import forensics as R
from tendermint_tpu_torch.libs import forensics as T


def test_a_beat_on_a_retired_ring(tmp_path):
    rings = {}
    for name, mod in (("ref", R), ("port", T)):
        hb = mod.Heartbeat(str(tmp_path / name / "heartbeat.bin"), slots=4)
        hb.beat("persig")
        hb.close()
        rings[name] = hb
    with pytest.raises(TypeError):
        rings["ref"].beat("rlc_submit")
    rings["port"].beat("rlc_submit")  # dropped
    assert [b["phase"] for b in T.Heartbeat.read(rings["port"].path)] == ["persig"]
    assert (tmp_path / "port" / "heartbeat.bin").read_bytes()[:16] == \
        (tmp_path / "ref" / "heartbeat.bin").read_bytes()[:16]


def test_configure_while_another_thread_beats(tmp_path):
    """Nodes configuring their rings one after another while a thread
    beats: no beat raises, and the last ring holds the last beats."""
    errors, stop = [], threading.Event()

    def beater():
        while not stop.is_set():
            try:
                T.beat("persig")
            except Exception as e:  # the fault this pins
                errors.append(e)
                return

    t = threading.Thread(target=beater)
    t.start()
    try:
        for i in range(40):
            T.configure(str(tmp_path / f"node{i}"))
        last = T.heartbeat_path()
        for _ in range(5000):  # the beater reaches the last ring
            if T.Heartbeat.read(last) or errors:
                break
            time.sleep(0.001)
    finally:
        stop.set()
        t.join()
        T.configure(None)
    assert errors == []
    assert T.Heartbeat.read(last)[-1]["phase"] == "persig"
