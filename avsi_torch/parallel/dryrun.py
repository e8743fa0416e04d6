"""Multi-device dry run: one full sharded training step on an n-device mesh
(port of `avsi/parallel/dryrun.py`).

`main(n)` builds an n-device mesh (`(n/2, 2)` with a model axis when n is
at least 4 and even, else `(n,)`), runs one sharded train step of the
flagship model (narrowed to net_dim [16, 16]) on a batch of 2n, then a
lockstep fleet of 2 x data streams split over the same mesh, and prints the
reference's `dryrun_multichip OK: ...` line.  The devices are `device`
repeated n times (the CPU by default, the counterpart of the reference's
virtual CPU mesh).  It runs in the calling process: the reference runs in
a fresh subprocess only so that JAX can pick its platform before any
backend starts, which PyTorch does not need.

    python -m avsi_torch.parallel.dryrun [n]
"""

from __future__ import annotations

import numpy as np
import torch


def main(n_devices: int, device="cpu") -> None:
    from avsi_torch.flagship import flagship_config, synthetic_batch
    from avsi_torch.infer import streaming
    from avsi_torch.models import registry
    from avsi_torch.parallel import mesh as mesh_lib
    from avsi_torch.train import loop as loop_lib
    from avsi_torch.train import state as state_lib

    device = torch.device(device)
    model_shards = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    mesh = mesh_lib.get_mesh(n_devices // model_shards, [device] * n_devices,
                             model_shards=model_shards)

    config = flagship_config(batch_size=8, net_dim=[16, 16], audio_len=4800)
    model = registry.get_model(config["model"])
    params = model.init(torch.Generator().manual_seed(0), config, device=device)
    stats = (np.zeros((257,), np.float32), np.ones((257,), np.float32))
    state = mesh_lib.shard_state(state_lib.create_train_state(params, config), mesh)
    step_fn = loop_lib.make_train_step(model, config, stats, device, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(1)
    ldict = step_fn(state, synthetic_batch(config, 2 * n_devices, seed=0), gen)
    loss = float(ldict["loss"])
    assert np.isfinite(loss), loss
    assert state.step == 1

    # the fleet of streams split over the data axis of the same mesh
    fleet = 2 * (n_devices // model_shards)
    fh = synthetic_batch(config, fleet, seed=2)
    wav = streaming.stream_utterances_lockstep(
        config, stats, mesh_lib.gather_tree(state.params), fh["target_sources"],
        fh["masks"][:, :, 0], fh["video_features"], chunk_frames=4, lookahead_frames=4,
        mesh=mesh, device=device,
    )
    assert wav.shape[0] == fleet and np.isfinite(wav).all()

    axes = "x".join(f"{k}={v}" for k, v in mesh.shape.items())
    print(
        f"dryrun_multichip OK: {n_devices} devices ({axes}), loss={loss:.4f}, "
        f"ctc={float(ldict['ctc_loss']):.2f}, fleet={fleet} sharded streams"
    )


if __name__ == "__main__":
    import sys

    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
