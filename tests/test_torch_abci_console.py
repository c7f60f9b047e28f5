"""The port's abci-cli console (cli/abci_console.py) against the JAX
package's and the reference's golden transcripts (tests/testdata/abci_ex*,
driven by tests/test_abci_cli.py).

The golden scripts give byte-identical transcripts from both consoles over
each in-process app, over the port's socket server and the reference's
(`tcp://`, abci/socket.py), and through the command line's `abci`
subcommand with a batch file; unknown commands, unbalanced quotes and
unknown apps are answered alike. No tolerance applies.
"""

import io
import os

import pytest

from tendermint_tpu.cli import abci_console as R_console
from tendermint_tpu_torch.cli import abci_console as T_console

HERE = os.path.dirname(__file__)
GOLDEN = {"kvstore": "abci_ex1.abci", "counter": "abci_ex2.abci"}


def script(name: str) -> str:
    with open(os.path.join(HERE, "testdata", name)) as f:
        return f.read()


def transcript(M, app_spec: str, text: str) -> str:
    out = io.StringIO()
    console = M.AbciConsole(app_spec)
    try:
        console.run_batch(text, out)
    finally:
        console.close()
    return out.getvalue()


@pytest.mark.parametrize("app", ["kvstore", "counter"])
def test_golden_scripts_in_process(app):
    name = GOLDEN[app]
    got = transcript(T_console, app, script(name))
    assert got == transcript(R_console, app, script(name))
    assert got == script(name + ".out")


EXTRA = """echo "hi there"
info
check_tx 0x00
deliver_tx "a=b"
deliver_tx 0xDEAD
commit
query "a"
query 0x00
frobnicate 0x00
check_tx "unbalanced
"""


@pytest.mark.parametrize("app", ["kvstore", "persistent_kvstore", "counter",
                                 "counter:noserial"])
def test_every_app_and_odd_lines_answer_alike(app):
    assert transcript(T_console, app, EXTRA) == transcript(R_console, app, EXTRA)


@pytest.mark.parametrize("server", ["port", "ref"])
def test_golden_script_over_a_socket_server(server):
    """Both consoles over `tcp://` to a socket server of either package."""
    if server == "port":
        from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
        from tendermint_tpu_torch.abci.socket import SocketServer
    else:
        from tendermint_tpu.abci.kvstore import KVStoreApplication
        from tendermint_tpu.abci.socket import SocketServer
    want = script("abci_ex1.abci.out")
    for M in (T_console, R_console):
        srv = SocketServer("tcp://127.0.0.1:0", KVStoreApplication())
        srv.start()
        try:
            got = transcript(M, f"tcp://127.0.0.1:{srv.bound_addr[1]}", script("abci_ex1.abci"))
        finally:
            srv.stop()
        assert got == want, M.__name__


def test_unknown_app_and_the_cli_subcommand(tmp_path, capsys):
    errs = []
    for M in (T_console, R_console):
        with pytest.raises(ValueError) as e:
            M.AbciConsole("not-an-app")
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    from tendermint_tpu_torch.cli.main import main

    path = tmp_path / "ex1.abci"
    path.write_text(script("abci_ex1.abci"))
    assert main(["--home", str(tmp_path), "abci", "--app", "kvstore", str(path)]) == 0
    assert capsys.readouterr().out == script("abci_ex1.abci.out")
