"""Image denoising with a grid MRF (the paper's Penguin/Art workload) on
the PyTorch/CUDA port, on one device or over a mesh of ranks (halo rows
exchanged between grid neighbours), as `examples/mrf_denoise.py` does on
the reference.

    PYTHONPATH=src python examples/torch_mrf_denoise.py              # the card
    PYTHONPATH=src python examples/torch_mrf_denoise.py --devices 8  # 2x4
    PYTHONPATH=src python examples/torch_mrf_denoise.py --device cpu \\
        --devices 2

`--devices N` (N > 1) spawns N ranks (`launch.mesh.spawn`) as a (2, N/2)
("data", "model") mesh: NCCL with a card a rank on the card, gloo on the
CPU.  It runs on the card by default and raises without one.
"""

import argparse

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.core import mrf as mrf_mod
from repro_torch.core.graphs import GridMRF


def _problem(args):
    clean, noisy = mrf_mod.make_denoising_problem(
        args.size, args.size, args.labels, args.noise, seed=0
    )
    m = GridMRF(args.size, args.size, args.labels, theta=1.2, h=2.0)
    return clean, noisy, m


def denoise_rank(rank, device_mesh, args):
    """One rank of the distributed run: its (chains, grid rows) block of
    the sampler, every rank returning the whole labels."""
    from repro_torch.core.distributed import RankMesh, mrf_gibbs_sharded

    _, noisy, m = _problem(args)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args.device == "cuda" else torch.device("cpu"))
    mesh = RankMesh(device_mesh, dev)
    labels = mrf_gibbs_sharded(
        m, torch.as_tensor(noisy, device=dev), prng.key(0), mesh,
        n_chains=2, n_iters=args.iters,
    )
    return labels.cpu()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--labels", type=int, default=4)
    ap.add_argument("--noise", type=float, default=0.25)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default=device_mod.DEFAULT,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    args.device = dev.type

    clean, noisy, m = _problem(args)
    if args.devices > 1:
        from repro_torch.launch import mesh as mesh_lib

        shape = (2, args.devices // 2)
        ranks = mesh_lib.spawn(
            denoise_rank, args.devices,
            backend="nccl" if dev.type == "cuda" else "gloo",
            device=dev.type, mesh_shape=shape, args=(args,))
        labels = ranks[0]
        assert all(torch.equal(r, labels) for r in ranks[1:])
        mode = (f"distributed {dict(zip(('data', 'model'), shape))} "
                "(halo exchange between ranks)")
    else:
        labels = mrf_mod.run_mrf_gibbs(
            m, torch.as_tensor(noisy, device=dev), prng.key(0), n_chains=2,
            n_iters=args.iters, device=dev,
        )
        mode = "single device"

    res = labels[0].cpu().numpy()
    err_in = (noisy != clean).mean()
    err_out = (res != clean).mean()
    print(f"[{mode}] {args.size}x{args.size} Potts-{args.labels}")
    print(f"noisy error {err_in:.3f} -> denoised error {err_out:.3f}")

    def ascii_img(img, rows=12, cols=48):
        chars = " .:-=+*#%@"
        rr = np.linspace(0, img.shape[0] - 1, rows).astype(int)
        cc = np.linspace(0, img.shape[1] - 1, cols).astype(int)
        for r in rr:
            print("".join(
                chars[int(img[r, c] * (len(chars) - 1)
                          / max(args.labels - 1, 1))]
                for c in cc))

    print("-- noisy --")
    ascii_img(noisy)
    print("-- denoised --")
    ascii_img(res)
    assert err_out < err_in / 2
    print("OK")


if __name__ == "__main__":
    main()
