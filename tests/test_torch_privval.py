"""PyTorch port, key management on the CPU: ``FilePV``'s key and state
files equal to the JAX package's for one seed, the double-sign guard, and
the remote signer across the packages in both directions over loopback
(the port's client against the JAX server and the JAX client against the
port's server), byte for byte (tolerance 0)."""

import hashlib
import json
import os
import threading
import time

import numpy as np
import pytest

import txflow_tpu.privval as jpv
import txflow_tpu.types as jtypes

import txflow_tpu_torch.privval as ppv
import txflow_tpu_torch.types as ptypes

CHAIN = "privval-chain"


def seed(i=0):
    return np.random.default_rng(4242 + i).bytes(32)


def tx_vote(types, pub_addr, t=0):
    tx = b"pv%d=v" % t
    key = hashlib.sha256(tx).digest()
    return types.TxVote(3, key.hex().upper(), key, 1_700_000_000_000_000_000 + t, pub_addr)


def test_file_pv_files_match_jax(tmp_path):
    s = seed()
    files = {}
    for name, mod in (("jax", jpv), ("port", ppv)):
        d = tmp_path / name
        d.mkdir()
        pv = mod.FilePV(str(d / "key.json"), str(d / "state.json"), seed=s)
        assert not (d / "state.json").exists()
        pv._sign_hrs(5, 0, 2, b"sign-bytes", b"no-ts", 123)
        v = tx_vote(jtypes if name == "jax" else ptypes, pv.get_address())
        pv.sign_tx_vote(CHAIN, v)
        files[name] = ((d / "key.json").read_bytes(), (d / "state.json").read_bytes(),
                       v.signature, pv.get_pub_key(), repr(pv))
        # reloaded from its files, the signer is the same
        again = mod.FilePV(str(d / "key.json"), str(d / "state.json"))
        assert (again.get_pub_key(), again.last_height, again.last_signature) == (
            pv.get_pub_key(), 5, pv.last_signature)
    assert files["port"] == files["jax"]
    assert json.loads(files["port"][1])["step"] == 2


def test_double_sign_guard_matches_jax(tmp_path):
    outcomes = {}
    for name, mod in (("jax", jpv), ("port", ppv)):
        d = tmp_path / name
        d.mkdir()
        pv = mod.FilePV.load_or_generate(str(d))
        out = [pv._sign_hrs(7, 1, 2, b"A-ts1", b"A", 1) == pv._sign_hrs(7, 1, 2, b"A-ts1", b"A", 1)]
        # same message, another timestamp: the stored signature and time
        sig, ts = pv._sign_hrs(7, 1, 2, b"A-ts2", b"A", 2)
        out.append((sig == pv.last_signature, ts))
        for hrs, sb, no_ts in (((7, 1, 2), b"B", b"B"), ((7, 0, 3), b"C", b"C"),
                               ((6, 9, 3), b"D", b"D")):
            with pytest.raises(mod.ErrDoubleSign) as e:
                pv._sign_hrs(*hrs, sb, no_ts, 1)
            out.append(str(e.value))
        out.append(pv._sign_hrs(7, 1, 3, b"E", b"E", 5)[1])  # the next step signs
        outcomes[name] = out
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] and outcomes["port"][1] == (True, 1)


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_remote_signer_across_packages(tmp_path, server_pkg):
    srv_mod, cli_mod = (jpv, ppv) if server_pkg == "jax" else (ppv, jpv)
    cli_types = ptypes if server_pkg == "jax" else jtypes
    s = seed(1)
    inner = srv_mod.FilePV(str(tmp_path / "k.json"), str(tmp_path / "s.json"), seed=s)
    server = srv_mod.SignerServer(inner)
    server.start()
    client = None
    before = set(threading.enumerate())
    try:
        client = cli_mod.SignerClient(*server.addr)
        assert client.get_pub_key() == inner.get_pub_key()
        assert client.get_address() == inner.get_address()
        direct = jtypes.MockPV(s)
        for t in range(3):
            v = tx_vote(cli_types, client.get_address(), t)
            client.sign_tx_vote(CHAIN, v)
            w = tx_vote(jtypes, direct.get_address(), t)
            direct.sign_tx_vote(CHAIN, w)
            assert v.signature == w.signature and v.timestamp_ns == w.timestamp_ns
        # an unknown request crosses as an error, the connection stays up
        with pytest.raises(cli_mod.RemoteSignerError):
            client._call({"type": "no_such_request"})
        v = tx_vote(cli_types, client.get_address(), 9)
        client.sign_tx_vote(CHAIN, v)
        assert v.signature
    finally:
        if client is not None:
            client.close()
        server.stop()
    if server_pkg == "port":
        # the port's server joins its accept and connection threads
        deadline = time.monotonic() + 5
        while set(threading.enumerate()) - before and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert os.path.exists(tmp_path / "k.json")
