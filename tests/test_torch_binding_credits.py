"""The credited torus where credits bind, port vs reference, as a script.

The full-width card run of the microcircuit on ``torus3d`` 2x2x2 with
binding credits (``chip_smoke.py``'s main path 3) fires far more spikes
than the crossbar or ample credits and misses deadlines, while the CPU
tests hold the credited simulator to the reference only at small scale.
This script runs the same configuration at a scale this CPU holds (the
microcircuit at 0.05, 8 shards, the paper's 124-event buckets, credits
that bind, notify latency 4, 25 windows) in the reference (one 8-device
subprocess) and in the port on the CPU, from the reference's initial state
and its replayed background drive (``PRNGKey(s + seed * 1000 + 7)``), and
compares every integer ``WindowStats`` / ``LinkStats`` field of every
window; the crossbar run of the same network is printed beside it.  It
fails unless the reference shows credit stalls and deadline misses (else
the credits did not bind) and the port equals it.

Not a tier-1 test (the reference takes about a minute):

    PYTHONPATH=src python tests/test_torch_binding_credits.py [--credits N]
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from md_helper import run_md  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.snn import microcircuit as mc, network  # noqa: E402
from repro_torch.snn import simulator as sim  # noqa: E402

SCALE, N_SHARDS, N_WINDOWS, SEED = 0.05, 8, 25, 0
BASE = dict(window=8, ring_len=32, e_max=1024, residue=256)
TORUS = dict(transport="torus3d", torus_nx=2, torus_ny=2, torus_nz=2,
             capacity=124, notify_latency=4)
CREDITS = 124           # main path 3's: one bucket per link

REF_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.snn import lif, microcircuit as mc, network, simulator as sim

out = {}
def flat(tree, prefix):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            flat(getattr(tree, f), prefix + f + ".")
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)     # numpy before any indexing

S, SEED, NW = %(S)d, %(SEED)d, %(NW)d
spec = mc.MicrocircuitSpec(scale=%(SCALE)r)
part = network.build_partition(*spec.weight_matrix(), n_shards=S)
per = part.per_shard
mesh = jax.make_mesh((S,), ("wafer",))
for name, kw in %(RUNS)r.items():
    cfg = sim.SimConfig(n_shards=S, per_shard=per,
                        max_fan=part.fanout.shape[1], **kw)
    init, run = sim.build_sharded_sim(mesh, "wafer", cfg, part,
                                      spec.bg_rates())
    st0 = init(SEED)
    st1, stats = run(st0, NW)
    flat(st0, name + ".init.")
    flat(stats, name + ".stats.")

bg = np.pad(spec.bg_rates(), (0, part.n_neurons - len(spec.bg_rates())))
bg = bg.reshape(S, per)

@jax.jit
def draws(key, rate):
    def step(k, _):
        k, sub = jax.random.split(k)
        return k, lif.poisson_input(sub, per, rate, 87.8, 0.1)
    return jax.lax.scan(step, key, None, length=NW * 8)[1]

drive = np.stack([np.asarray(draws(jax.random.PRNGKey(s + SEED * 1000 + 7),
                                   jnp.asarray(bg[s]))) for s in range(S)])
out["drive"] = drive.reshape(S, NW, 8, per).transpose(1, 2, 0, 3)
np.savez(%(PATH)r, **out)
print("REF_OK")
"""


def runs(credits: int) -> dict:
    return {"alltoall": dict(BASE, transport="alltoall", capacity=124),
            "binding": dict(BASE, **TORUS, link_credits=credits)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--credits", type=int, default=CREDITS)
    args = ap.parse_args(argv)
    cases = runs(args.credits)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "binding.npz")
        out = run_md(REF_SCRIPT % dict(S=N_SHARDS, SEED=SEED, NW=N_WINDOWS,
                                       SCALE=SCALE, RUNS=cases, PATH=path),
                     n_devices=N_SHARDS, timeout=1200)
        assert "REF_OK" in out
        with np.load(path) as f:
            ref = dict(f)
    spec = mc.MicrocircuitSpec(scale=SCALE)
    part = network.build_partition(*spec.weight_matrix(), n_shards=N_SHARDS)
    ok = True
    for name, kw in cases.items():
        cfg = sim.SimConfig(n_shards=N_SHARDS, per_shard=part.per_shard,
                            max_fan=part.fanout.shape[1], **kw)
        _, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                       device="cpu")
        state0 = convert.state_from_reference(ref, prefix=f"{name}.init.",
                                              device="cpu")
        _, stats = run(state0, N_WINDOWS,
                       drive=torch.from_numpy(ref["drive"]))
        got = convert.flatten(stats)
        prefix = f"{name}.stats."
        want = {k[len(prefix):]: v for k, v in ref.items()
                if k.startswith(prefix)}
        differ = [k for k, v in want.items() if v.dtype.kind != "f"
                  and (got[k].shape != v.shape or (got[k] != v).any())]
        first = None
        for k in differ:
            w = int(np.argmax((got[k] != want[k]).any(axis=0)))
            first = min(first or (w, k), (w, k))
        ints = sum(v.dtype.kind != "f" for v in want.values())
        total = lambda d, k: int(d[k].sum())
        credits = (f", credits {kw['link_credits']}"
                   if "link_credits" in kw else "")
        print(f"{name} (scale {SCALE}, {N_SHARDS} shards, {N_WINDOWS} "
              f"windows{credits}): "
              f"reference / port spikes {total(want, 'spikes')} / "
              f"{total(got, 'spikes')}, deadline misses "
              f"{total(want, 'deadline_miss')} / {total(got, 'deadline_miss')}"
              f", credit stalls {total(want, 'link.credit_stalls')} / "
              f"{total(got, 'link.credit_stalls')}, deferred "
              f"{total(want, 'deferred')} / {total(got, 'deferred')}, parked "
              f"{total(want, 'link.parked_events')} / "
              f"{total(got, 'link.parked_events')}; {ints - len(differ)} of "
              f"{ints} integer fields equal in every window"
              + (f"; first difference: {first[1]} at window {first[0]}"
                 if differ else ""))
        ok &= not differ
        if name == "binding" and not (total(want, "link.credit_stalls") > 0
                                      and total(want, "deadline_miss") > 0):
            print("the credits did not bind: no stalls or no misses in the "
                  "reference")
            ok = False
    print("port == reference" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
