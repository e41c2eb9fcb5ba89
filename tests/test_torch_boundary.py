"""PyTorch port, import boundary and device rule: no module of
txflow_tpu_torch (nor chip_smoke.py) imports JAX or the JAX package, and
the port's entry points never move to the CPU on their own."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys

sys.modules["jax"] = None  # any "import jax" now raises ImportError


class _BlockJaxPackage:
    def find_spec(self, name, path=None, target=None):
        if name == "txflow_tpu" or name.startswith("txflow_tpu."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, _BlockJaxPackage())
import txflow_tpu_torch

names = [m.name for m in pkgutil.walk_packages(txflow_tpu_torch.__path__, "txflow_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its work runs only under __main__)

bad = [k for k, v in sys.modules.items() if v is not None and (k == "jax" or k.startswith(("jax.", "jaxlib", "txflow_tpu.")) or k == "txflow_tpu")]
assert not bad, bad
print(" ".join(names))
print(len(names))
"""


GOSSIP_MODULES = (
    "p2p.base", "p2p.transport", "p2p.switch", "p2p.secret", "p2p.pex", "crypto.x25519",
    "node.id", "node.node", "node.localnet", "reactors.mempool_reactor",
    "reactors.txvote_reactor", "privval.file", "privval.signer",
)


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert int(lines[-1]) >= 75  # every module imported
    # the gossip and node slice: each of its modules is among them
    names = set(lines[-2].split())
    for mod in GOSSIP_MODULES:
        assert "txflow_tpu_torch." + mod in names, mod


def test_device_verifier_without_cuda_raises(monkeypatch):
    from txflow_tpu_torch.crypto import ed25519
    from txflow_tpu_torch.types import Validator, ValidatorSet
    from txflow_tpu_torch.verifier import DeviceVoteVerifier, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pub = ed25519.public_key_from_seed(bytes(32))
    vals = ValidatorSet([Validator.from_pub_key(pub, 10)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceVoteVerifier(vals)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceVoteVerifier(vals, device="cuda")
    assert DeviceVoteVerifier(vals, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
