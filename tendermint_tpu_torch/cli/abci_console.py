"""abci-cli: interactive/batch console for ABCI applications, the port's
copy of tendermint_tpu/cli/abci_console.py.

The conformance tool for out-of-process apps (reference:
abci/cmd/abci-cli/abci-cli.go + abci/tests/test_cli/ golden round-trips):
feed a script of commands, get deterministic "-> field: value" output that a
golden file pins. Commands mirror the reference console:

    echo <string> | info | check_tx <tx> | deliver_tx <tx> | commit |
    query <data>

Tx/data arguments are 0x-hex or (optionally quoted) strings. Apps: the
in-proc examples by name ("kvstore", "persistent_kvstore", "counter",
"counter:noserial") or `tcp://host:port` for a remote socket server
(abci/socket.py SocketClient)."""

from __future__ import annotations

import shlex
import sys
from typing import List

from tendermint_tpu_torch.abci import types as abci


def _parse_arg(raw: str) -> bytes:
    raw = raw.strip()
    if (raw.startswith('"') and raw.endswith('"')) or (
        raw.startswith("'") and raw.endswith("'")
    ):
        raw = raw[1:-1]
    if raw.startswith("0x"):
        return bytes.fromhex(raw[2:])
    return raw.encode()


def _fmt_code(code: int) -> str:
    return "OK" if code == abci.CODE_TYPE_OK else str(code)


def _printable(data: bytes) -> bool:
    return all(0x20 <= b < 0x7F for b in data)


class AbciConsole:
    """Drives one app (in-proc object or socket client) synchronously."""

    def __init__(self, app_spec: str):
        self._client = None
        self._app = None
        if app_spec.startswith("tcp://") or app_spec.startswith("unix://"):
            from tendermint_tpu_torch.abci.socket import SocketClient

            self._client = SocketClient(app_spec)
        else:
            from tendermint_tpu_torch.abci.kvstore import (
                CounterApplication,
                KVStoreApplication,
                PersistentKVStoreApplication,
            )

            apps = {
                "kvstore": KVStoreApplication,
                "persistent_kvstore": PersistentKVStoreApplication,
                "counter": CounterApplication,
                "counter:noserial": lambda: CounterApplication(serial=False),
            }
            if app_spec not in apps:
                raise ValueError(f"unknown app {app_spec!r} (or use tcp://host:port)")
            self._app = apps[app_spec]()

    # -- dispatch ----------------------------------------------------------

    def _call(self, method: str, req):
        target = self._app if self._app is not None else self._client
        fn = getattr(target, method)
        return fn(req) if req is not None else fn()

    def run_line(self, line: str, out) -> None:
        line = line.strip()
        if not line or line.startswith("#"):
            return
        try:
            parts = shlex.split(line, posix=False)
            cmd, args = parts[0], parts[1:]
        except ValueError as e:  # unbalanced quotes etc. must not kill the batch
            out.write(f"> {line}\n-> error: {e}\n\n")
            return
        out.write(f"> {line if args else line + ' '}\n")
        try:
            self._dispatch(cmd, args, out)
        except Exception as e:  # keep the console alive, pin the error text
            out.write(f"-> error: {e}\n")
        out.write("\n")

    def _dispatch(self, cmd: str, args: List[str], out) -> None:
        if cmd == "echo":
            msg = args[0] if args else ""
            if msg and msg[0] in "\"'":
                msg = msg[1:-1]
            out.write("-> code: OK\n")
            out.write(f"-> data: {msg}\n")
            out.write(f"-> data.hex: 0x{msg.encode().hex().upper()}\n")
            return
        if cmd == "info":
            res = self._call("info", abci.RequestInfo())
            out.write("-> code: OK\n")
            if res.data:
                out.write(f"-> data: {res.data}\n")
                out.write(f"-> data.hex: 0x{res.data.encode().hex().upper()}\n")
            return
        if cmd == "check_tx":
            res = self._call("check_tx", abci.RequestCheckTx(tx=_parse_arg(args[0])))
            out.write(f"-> code: {_fmt_code(res.code)}\n")
            if res.log:
                out.write(f"-> log: {res.log}\n")
            return
        if cmd == "deliver_tx":
            res = self._call("deliver_tx", abci.RequestDeliverTx(tx=_parse_arg(args[0])))
            out.write(f"-> code: {_fmt_code(res.code)}\n")
            if res.log:
                out.write(f"-> log: {res.log}\n")
            return
        if cmd == "commit":
            res = self._call("commit", None)
            out.write("-> code: OK\n")
            out.write(f"-> data.hex: 0x{res.data.hex().upper()}\n")
            return
        if cmd == "query":
            res = self._call("query", abci.RequestQuery(data=_parse_arg(args[0])))
            out.write(f"-> code: {_fmt_code(res.code)}\n")
            if res.log:
                out.write(f"-> log: {res.log}\n")
            if res.key:
                out.write(f"-> key: {res.key.decode() if _printable(res.key) else ''}\n")
                out.write(f"-> key.hex: {res.key.hex().upper()}\n")
            if res.value:
                out.write(
                    f"-> value: {res.value.decode() if _printable(res.value) else ''}\n"
                )
                out.write(f"-> value.hex: {res.value.hex().upper()}\n")
            if res.height:
                out.write(f"-> height: {res.height}\n")
            return
        raise ValueError(f"unknown command {cmd!r}")

    def run_batch(self, script: str, out) -> None:
        for line in script.splitlines():
            self.run_line(line, out)

    def close(self) -> None:
        if self._client is not None:
            self._client.close()


def main(app_spec: str, batch_file: str | None, out=None) -> None:
    out = out or sys.stdout
    console = AbciConsole(app_spec)
    try:
        if batch_file:
            with open(batch_file) as f:
                console.run_batch(f.read(), out)
        else:
            for line in sys.stdin:
                console.run_line(line, out)
    finally:
        console.close()
