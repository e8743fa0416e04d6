"""The control and the fault that set each check's upper reading.

    python -m perfbench.tests.controls <cell> <seed> [<seed> ...]

runs, for each seed, at the cell's own size (its checked steps on the
rows a run checks), the reference put in the program's place: in TF32
(the precision below the configuration's float32, the control) and with
half of each batch left out (the mean over the rest, a fault).  Each is
compared with the float32 reference by the cell's own numbers; one JSON
line per seed.  A step that returns its state unchanged reads 1 on
`change_gap` and needs no run.  `test_perfbench_controls.py` runs the same
at a small size on the CPU.
"""

from __future__ import annotations

import json
import sys

import torch

from perfbench.lib import corpus as corpus_lib
from perfbench.lib import spec, weights
from perfbench.loops import train
from perfbench.reference.arith import Arith
from perfbench.reference.training import adam_steps, compare


def train_readings(config: dict, traffic: dict, seed: int, device) -> dict:
    m, geo = config["model"], config["geometry"]
    ref = spec.reference_module(config)
    corpus = corpus_lib.draw(seed, m, geo, traffic, device)
    groups, order_rng = train.plan(seed, traffic)
    order = order_rng.permutation(len(groups))
    rows = [groups[order[k]] for k in range(int(traffic["checked_steps"]))]
    init = weights.draw(ref.param_shapes(m), seed, device)
    st = tuple(torch.from_numpy(a).to(device)
               for a in weights.stats(seed, int(m["audio_feat_dim"]), config["stats"]))
    full = [corpus_lib.ref_batch(corpus, r, device) for r in rows]
    half = [corpus_lib.ref_batch(corpus, r[:len(r) // 2], device) for r in rows]
    want = adam_steps(ref, Arith(), init, full, m, geo, st)
    return {"control_tf32": compare(adam_steps(ref, Arith(tf32=True), init, full, m, geo, st),
                                    want)[0],
            "fault_half_batch": compare(adam_steps(ref, Arith(), init, half, m, geo, st),
                                        want)[0]}


def readings(cell_name: str, seed: int, device) -> dict:
    _, config, traffic = spec.cell_files(spec.load_benchmark(), cell_name)
    return train_readings(config, traffic, seed, device)


if __name__ == "__main__":
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in sys.argv[2:]:
        out = readings(sys.argv[1], int(seed), dev)
        print(json.dumps({"cell": sys.argv[1], "seed": int(seed), **out}), flush=True)
