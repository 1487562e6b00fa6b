"""Using the real Inception-v3 pool3 for reference-comparable FID.

Offline environments can't download the pretrained weights, but the full
architecture + loaders ship in-tree. The moment you have a pytorch-fid /
torchvision checkpoint (pt_inception-2015-12-05 state dict), convert once
and every FID in the framework becomes Inception-FID:

    import torch
    from collaborative_gan_sampling_torch.evals.inception import (
        inception_from_torch_state_dict, save_inception_params)

    sd = torch.load("pt_inception-2015-12-05.pth", map_location="cpu")
    save_inception_params("inception_v3.msgpack",
                          inception_from_torch_state_dict(sd))

Then point any config at it:

    python -m collaborative_gan_sampling_torch.cli eval --config celeba \
        eval.feature_net=inception:inception_v3.msgpack

For a smoke run without real weights (features are meaningless but the
whole pipeline executes), this script writes random-init variables:

    python examples_torch/inception_fid.py [--device cpu]

The PyTorch counterpart of ``examples/inception_fid.py``; it writes under
``runs/inception_fid/`` where that one writes to ``/tmp``. The file is in
the Flax msgpack format of either package.
"""

if __name__ == "__main__":
    import argparse

    import torch

    from collaborative_gan_sampling_torch.evals.inception import (
        init_inception,
        save_inception_params,
    )
    from collaborative_gan_sampling_torch.models import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args()

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    path = save_inception_params("runs/inception_fid/incep_rand.msgpack",
                                 init_inception(gen, dev))
    print(f"random-init Inception variables written to {path}; pass "
          f"eval.feature_net=inception:{path} to any cli command")
