"""Parent-against-this comparisons of the port on one NVIDIA GPU.

Unpack the commit to compare with into a directory that .gitignore
lists, then run from the repo root:

    mkdir -p txflow_tpu_torch/_build/parent
    git archive PARENT_COMMIT | tar -x -C txflow_tpu_torch/_build/parent
    python3 -m txflow_tpu_torch.parent_ab --launch-ab txflow_tpu_torch/_build/parent
    python3 -m txflow_tpu_torch.parent_ab --fingerprints txflow_tpu_torch/_build/parent

``--launch-ab PARENT`` times the small kernels' wrappers (K4, the K7
partial, reduce and ring hop, and torch.add beside them) of the checkout
at PARENT and of this one in turns (parent, this, this, parent), one
process each that imports its tree's package and builds its tree's tally
library; writes chiprun_out/parent_ab_launch.json.

``--fingerprints PARENT`` runs the default run of ``chip_smoke.py`` of
the checkout at PARENT and of this one, one process each, and requires
every phase's certificate rows and app digest (slice, radix 13, int64,
the committee server and both followers, the mesh and one-card engines)
to be equal; writes chiprun_out/parent_ab_fingerprints.json. It takes
two default runs' time.

Nothing runs on import: the module only reads this tree's chip_smoke.py
when a mode starts.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.abspath(__file__)


def _chip_smoke():
    """This tree's chip_smoke.py as a module (its kernels' timing window
    and the main path's shapes). It imports ``txflow_tpu_torch`` from the
    first tree on ``sys.path``: in ``--launch-only``, the measured one."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_kernel_times(cs) -> dict:
    """Milliseconds a launch of each small kernel's wrapper, at the main
    path's shapes on seeded inputs, each 500 launches in one CUDA-event
    window after 5 of warmup: K4 ``tally_into`` (16384 votes, 4096
    slots), K7 ``tally_partial`` (4096 votes, one of 4 shards),
    ``reduce_quorum`` (4 partials x 4096 slots), the ring hop ``ring_add``
    (4096 slots, as the tree's ring uses it) and ``torch.add`` beside it.
    Only wrapper names and signatures that both trees have."""
    import numpy as np
    import torch

    from txflow_tpu_torch.ops import tally

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 23)
    b, s = cs.MAX_BATCH, cs.N_TXS

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    valid = T(rng.integers(0, 2, b).astype(np.int32))
    slot = T(rng.integers(-1, s, b).astype(np.int32))
    vidx = T(rng.integers(0, cs.N_VALS, b).astype(np.int32))
    powers = T((10 * (1 + np.arange(32) % 4)).astype(np.int32))
    prior = T(rng.integers(0, 200, s).astype(np.int32))
    stake = torch.empty(s, dtype=torch.int32, device=dev)
    maj = torch.empty(s, dtype=torch.int32, device=dev)
    q = b // cs.MESH_SHARDS
    parts = torch.stack([tally.tally_partial(valid[i * q:(i + 1) * q], slot[i * q:(i + 1) * q],
                                             vidx[i * q:(i + 1) * q], powers, s)
                         for i in range(cs.MESH_SHARDS)])
    acc, hop = parts[0].clone(), parts[1]
    fns = {
        "tally_into": lambda: tally.tally_into(stake, maj, valid, slot, vidx, powers, prior, 267),
        "tally_partial": lambda: tally.tally_partial(valid[:q], slot[:q], vidx[:q], powers, s),
        "reduce_quorum": lambda: tally.reduce_quorum(parts, prior, 267),
        "ring_add": lambda: tally.ring_add(acc, hop),
        "torch_add": lambda: torch.add(acc, hop),
    }
    return {k: cs.cuda_ms_window(fn, 500, warmup=5) for k, fn in fns.items()}


def launch_only() -> None:
    """``--launch-only``, run with a tree's root first on ``sys.path``:
    build that tree's tally library alone through its own ``_lib``, then
    print ``small_kernel_times`` as one JSON line."""
    from txflow_tpu_torch.ops import _lib

    _lib.LIBS = {"tally": _lib.LIBS["tally"]}  # build_all then builds tally alone
    _lib.library("tally")
    print(json.dumps({"tree": str(_lib.PKG.parent), "ms": small_kernel_times(_chip_smoke())}),
          flush=True)


def _run(tree: str, code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"the run in {tree} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def launch_ab(parent: str) -> dict:
    """The small kernels' launch times of the checkout at PARENT and of
    this one, in turns (parent, this, this, parent)."""
    runs = []
    for tree in (parent, HERE, HERE, parent):
        code = ("import runpy, sys; sys.path.insert(0, %r); sys.argv = [%r, '--launch-only']; "
                "runpy.run_path(%r, run_name='__main__')" % (tree, SCRIPT, SCRIPT))
        got = _run(tree, code)
        if got["tree"] != tree:
            raise RuntimeError(f"the run in {tree} imported the package of {got['tree']}")
        runs.append(got)
    return {k: {"parent": [runs[0]["ms"][k], runs[3]["ms"][k]], "this": [runs[1]["ms"][k], runs[2]["ms"][k]]}
            for k in runs[0]["ms"]}


# Run in a process of its own with a checkout's root first on sys.path:
# that checkout's chip_smoke.main() (its default run), with every TxStore
# and KVStoreApplication the run makes recorded; then one JSON line of a
# sha256 per store over its certificate rows in commit order, and each
# app's digest, in the order the run made them.
_FINGERPRINT_RUN = """
import hashlib, json, sys
sys.path.insert(0, {tree!r})
sys.argv = ["chip_smoke.py"]
import chip_smoke as cs
stores, apps = [], []
class Store(cs.TxStore):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        stores.append(self)
class App(cs.KVStoreApplication):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        apps.append(self)
cs.TxStore, cs.KVStoreApplication = Store, App
rc = cs.main()
def rows(st):
    return hashlib.sha256(b"".join(h.encode() + st.load_cert_row(h)
                                   for h in st.committed_hashes_in_order())).hexdigest()
print(json.dumps({{"tree": cs.__file__, "rc": rc, "stores": [rows(st) for st in stores],
                  "commits": [st.seq_count() for st in stores],
                  "apps": [a.digest.hex() for a in apps]}}))
"""


def fingerprints(parent: str) -> dict:
    """The default run of the checkout at PARENT and of this one, every
    certificate store and app digest fingerprinted; every phase's
    certificates and app digest must be equal."""
    runs = {}
    for name, tree in (("parent", parent), ("this", HERE)):
        runs[name] = _run(tree, _FINGERPRINT_RUN.format(tree=tree))
        if runs[name]["rc"] != 0:
            raise RuntimeError(f"the default run in {tree} returned {runs[name]['rc']}")
        if runs[name]["tree"] != os.path.join(tree, "chip_smoke.py"):
            raise RuntimeError(f"the run in {tree} imported {runs[name]['tree']}")
    p, t = runs["parent"], runs["this"]
    if not (len(t["stores"]) == 8 and t["stores"] == p["stores"] and t["commits"] == p["commits"]):
        raise RuntimeError(f"certificate rows differ from the parent's: {p} != {t}")
    if t["apps"] != p["apps"]:
        raise RuntimeError(f"app digests differ from the parent's: {p} != {t}")
    return {"parent": p, "this": t}


def main(argv: list[str]) -> int:
    if argv == ["--launch-only"]:
        launch_only()
        return 0
    modes = {"--launch-ab": (launch_ab, "launch", "launch_ab_ms"),
             "--fingerprints": (fingerprints, "fingerprints", "fingerprints")}
    if len(argv) != 2 or argv[0] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    fn, tag, key = modes[argv[0]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    got = fn(os.path.abspath(argv[1]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"parent_ab_{tag}.json"), "w") as f:
        json.dump({"card": card, key: got}, f, indent=1)
    print(json.dumps({key: got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
