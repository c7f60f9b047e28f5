"""The port's Config and config.toml against the JAX package's, tolerance 0:
a config with a non-default value in every field of every section is
written by the reference and read by the port, then written by the port
and read by the reference; the fields are equal and the two TOML texts are
byte-equal. `default_config()` and `test_config()` are equal field by
field, and `convert.config_from_reference` carries a whole Config across.
"""

import dataclasses

import numpy as np
import pytest

from tendermint_tpu_torch import convert
from tests.test_torch_consensus_util import Pkg

REF, PORT = Pkg("ref"), Pkg("port")
SEED = 20261022


def _plain(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _non_default(seed: int):
    """A reference Config whose every field differs from its default,
    drawn from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    cfg = REF.config.Config()
    for section in dataclasses.fields(cfg):
        sub = getattr(cfg, section.name)
        if section.name == "root_dir":
            cfg.root_dir = "/srv/node-%d" % rng.integers(1000)
            continue
        for f in dataclasses.fields(sub):
            v = getattr(sub, f.name)
            if isinstance(v, bool):
                new = not v
            elif isinstance(v, int):
                new = v + int(rng.integers(1, 50))
            elif isinstance(v, float):
                new = v + float(rng.integers(1, 64)) / 8.0
            elif isinstance(v, str):
                new = v + "-x%d" % rng.integers(100) + ' "q"\\'
            elif isinstance(v, list):
                new = ["http://a:%d" % rng.integers(9999), "http://b:1"]
            else:
                raise AssertionError((section.name, f.name, type(v)))
            setattr(sub, f.name, new)
    return cfg


def test_default_and_test_config_equal_field_by_field():
    assert _plain(PORT.config.default_config()) == _plain(REF.config.default_config())
    assert _plain(PORT.config.test_config()) == _plain(REF.config.test_config())
    names = [f.name for f in dataclasses.fields(PORT.config.Config)]
    assert names == [f.name for f in dataclasses.fields(REF.config.Config)]


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_toml_round_trip_both_ways(seed, tmp_path):
    ref_cfg = _non_default(seed)
    defaults = _plain(REF.config.Config())
    for name, sec in _plain(ref_cfg).items():
        if isinstance(sec, dict):
            assert all(sec[k] != defaults[name][k] for k in sec), name
    port_cfg = convert.config_from_reference(ref_cfg)
    assert _plain(port_cfg) == _plain(ref_cfg)

    ref_path, port_path = str(tmp_path / "ref.toml"), str(tmp_path / "port.toml")
    REF.toml.save_config(ref_cfg, ref_path)
    PORT.toml.save_config(port_cfg, port_path)
    with open(ref_path, "rb") as f:
        ref_text = f.read()
    with open(port_path, "rb") as f:
        assert f.read() == ref_text

    # the reference writes, the port reads; and the other way round (root_dir
    # is not a config.toml key in either package)
    read_by_port = PORT.toml.load_config(ref_path)
    read_by_ref = REF.toml.load_config(port_path)
    assert _plain(read_by_port) == _plain(read_by_ref)
    want = _plain(ref_cfg)
    want["root_dir"] = ""
    assert _plain(read_by_port) == want
    assert PORT.toml.dumps(read_by_port).encode() == ref_text


def test_json_save_load_matches(tmp_path):
    cfg = _non_default(SEED + 2)
    REF.config.Config.save(cfg, str(tmp_path / "ref.json"))
    port = PORT.config.Config.load(str(tmp_path / "ref.json"))
    assert _plain(port) == _plain(cfg)
