"""The port's registered-type JSON (libs/amino_json.py) and key armor
(crypto/armor.py) against the JAX package's.

Both packages marshal the same keys to the same JSON; each unmarshals the
other's output to the same key bytes; the same armor block decodes to the
same headers and body in both; each package decrypts the other's
passphrase-encrypted key; a wrong passphrase, a tampered body and hostile
scrypt headers give the same error in both. No tolerance applies.
"""

import base64

import pytest

from tendermint_tpu.crypto import armor as R_armor
from tendermint_tpu.crypto import keys as R_keys
from tendermint_tpu.crypto import sr25519 as R_sr
from tendermint_tpu.libs import amino_json as R_amino
from tendermint_tpu_torch.crypto import armor as T_armor
from tendermint_tpu_torch.crypto import keys as T_keys
from tendermint_tpu_torch.crypto import sr25519 as T_sr
from tendermint_tpu_torch.libs import amino_json as T_amino

SEED = b"\x42" * 32


def _keys(which: str):
    K, S = (R_keys, R_sr) if which == "ref" else (T_keys, T_sr)
    priv = K.gen_ed25519(SEED)
    return {"ed25519_pub": priv.pub_key(), "ed25519_priv": priv,
            "sr25519_pub": S.gen_sr25519(SEED).pub_key()}


@pytest.mark.parametrize("kind", ["ed25519_pub", "ed25519_priv", "sr25519_pub"])
def test_marshal_equal_and_each_reads_the_other(kind):
    r, t = _keys("ref")[kind], _keys("port")[kind]
    assert t.bytes() == r.bytes()
    js = T_amino.marshal(t)
    assert js == R_amino.marshal(r)
    back_r = R_amino.unmarshal(js)
    back_t = T_amino.unmarshal(R_amino.marshal(r))
    assert type(back_t) is type(t) and back_t.bytes() == t.bytes()
    assert back_r.bytes() == r.bytes()
    assert T_amino.unmarshal(js).bytes() == t.bytes()


@pytest.mark.parametrize("data", [
    '{"value": "x"}', "[1, 2]", '{"type": "tendermint/PubKeyMystery", "value": ""}',
])
def test_unmarshal_rejections_equal(data):
    def err(M):
        try:
            M.unmarshal(data)
        except Exception as e:  # noqa: BLE001 - the rejection is the result
            return type(e).__name__, str(e)
        return None

    assert err(T_amino) == err(R_amino) is not None
    with pytest.raises(T_amino.UnregisteredTypeError):
        T_amino.marshal(object())
    with pytest.raises(ValueError):
        T_amino.register(dict, "tendermint/PubKeyEd25519", str, str)


@pytest.mark.parametrize("headers,data", [
    ({}, b""), ({"type": "ed25519"}, b"\x01" * 10),
    ({"b": "2", "a": "1", "salt": "00FF"}, bytes(range(256)) * 3),
])
def test_armor_encode_decode_equal(headers, data):
    text = T_armor.encode_armor("PRIVATE KEY", headers, data)
    assert text == R_armor.encode_armor("PRIVATE KEY", headers, data)
    assert T_armor.decode_armor(text) == R_armor.decode_armor(text) == (
        "PRIVATE KEY", headers, data)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_encrypted_key_crosses_packages(direction):
    src, dst = (R_armor, T_armor) if direction == "ref_to_port" else (T_armor, R_armor)
    key = R_keys.gen_ed25519(SEED).bytes()
    text = src.encrypt_armor_priv_key(key, "correct horse", key_type="ed25519")
    assert dst.unarmor_decrypt_priv_key(text, "correct horse") == (key, "ed25519")


def _armor_error(A, text, passphrase):
    try:
        A.unarmor_decrypt_priv_key(text, passphrase)
    except A.ArmorError as e:
        return str(e)
    return None


def _with_headers(text: str, **changes) -> str:
    block, headers, body = R_armor.decode_armor(text)
    headers = {**headers, **changes}
    return R_armor.encode_armor(block, headers, body)


def test_wrong_passphrase_and_hostile_armor_give_the_same_errors():
    text = R_armor.encrypt_armor_priv_key(b"\x07" * 32, "right")
    _, headers, body = R_armor.decode_armor(text)
    cases = {
        "wrong passphrase": (text, "wrong"),
        "tampered body": (R_armor.encode_armor("PRIVATE KEY", headers,
                                               bytes([body[0] ^ 1]) + body[1:]), "right"),
        "n not a power of two": (_with_headers(text, n="1000"), "right"),
        "n too large": (_with_headers(text, n=str(1 << 22)), "right"),
        "r out of range": (_with_headers(text, r="64"), "right"),
        "bad kdf": (_with_headers(text, kdf="pbkdf2"), "right"),
        "bad salt": (_with_headers(text, salt="zz"), "right"),
        "wrong block": (R_armor.encode_armor("PUBLIC KEY", headers, body), "right"),
        "no end line": (text.strip().rsplit("\n", 1)[0], "right"),
        "no start line": ("hello\n", "right"),
        "bad body": (text.replace(base64.b64encode(body).decode()[:8], "!!!!@@@@"), "right"),
    }
    for name, (t, pw) in cases.items():
        want = _armor_error(R_armor, t, pw)
        assert want is not None, name
        assert _armor_error(T_armor, t, pw) == want, name
