"""Ex15: multi-host scale-out — one GLOBAL mesh spanning OS processes.

Run it directly::

    python examples_torch/ex15_multihost.py [--cpu]

With no rank environment set, the script plays the launcher: it starts
itself as TWO "hosts" of FOUR ranks each (``run_multicontroller``: one OS
process per device, each with torchrun's ``RANK``/``LOCAL_RANK``/
``MASTER_PORT`` environment), joined into ONE gloo group by
``init_multihost``. Inside a rank the group has EIGHT ranks — four on its
host, four on the other — and one ``DeviceMesh`` spans them. The LM train
step then runs over that global (dp, tp) mesh unchanged: its collectives
cross the process boundary, and every rank observes the same losses,
because there is only ONE program. On the card every rank runs on it.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import device  # noqa: E402


def controller():
    import numpy as np
    import torch.distributed as dist

    from parsec_tpu_torch.parallel.model import (ModelConfig, init_lm_params,
                                                 make_lm_train_step)
    from parsec_tpu_torch.parallel.multihost import (ENV_HOST,
                                                     fetch_replicated,
                                                     global_mesh,
                                                     init_multihost)
    pid = init_multihost()
    dev = "cpu" if device() == "cpu" else "cuda"
    mesh = global_mesh(("dp", "tp"), (2, 4), device_type=dev)
    print(f"rank {pid} (host {os.environ[ENV_HOST]}, local rank "
          f"{os.environ['LOCAL_RANK']}) of {dist.get_world_size()}; mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
    cfg = ModelConfig(vocab_size=64, d_model=32, d_ff=64, n_heads=4,
                      n_layers=2, max_seq=16)
    params = init_lm_params(0, cfg)          # identical on every rank
    step, place_p, place_t = make_lm_train_step(mesh, params=params, lr=0.1)
    params = place_p(params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 64, size=(8, 8)).astype(np.int32)
    tokens, targets = place_t(toks[:, :-1]), place_t(toks[:, 1:])
    for i in range(3):
        params, loss = step(params, tokens, targets)
        print(f"rank {pid}: step {i} loss "
              f"{float(fetch_replicated(loss)):.4f}", flush=True)
    dist.destroy_process_group()


def main():
    from parsec_tpu_torch.parallel.multihost import (ENV_NPROC,
                                                     run_multicontroller)
    if os.environ.get(ENV_NPROC):
        controller()
        return
    outs = run_multicontroller(2, os.path.abspath(__file__),
                               devices_per_proc=4, device_type=device())
    for o in outs:
        sys.stdout.write("".join(line + "\n" for line in o.splitlines()
                                 if line.startswith("rank ")))
    # every rank printed the same losses: one global program
    losses = [[ln.split("loss")[1] for ln in o.splitlines() if " loss " in ln]
              for o in outs]
    assert len(losses) == 8 and all(len(l) == 3 for l in losses)
    assert all(l == losses[0] for l in losses), losses
    print("ex15 OK: multi-controller, identical losses on all 8 ranks of "
          "the 2 hosts")


if __name__ == "__main__":
    main()
