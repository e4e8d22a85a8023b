"""How well a few f32 training steps of the port's ResNet-50 are
conditioned: the steps in f32 on the CPU (and on the card, where there is
one) against the same steps in f64 on the CPU, from the same weights and
batches. Per tensor (every parameter and BatchNorm running stat) it prints
the largest distance between two runs over the largest change that the
f64 steps made to that tensor, and the worst and the median of these per
pair of runs, for the weights and for the running stats apart.

The steps are ``chip_smoke.py``'s ResNet cell: ``Momentum(0.1, 0.9,
weight_decay=L2Decay(1e-4))`` on ``CrossEntropyLoss(label_smoothing=
0.1)``, through ``TrainStep``, the batches uniform in [0, 1) from
``--seed``.

    python tools/resnet_step_conditioning.py --shape 16 3 224 224 --steps 2
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.convert import (  # noqa: E402
    export_reference_state_dict, load_reference_state_dict)
from paddle_tpu_torch.jit import TrainStep  # noqa: E402


STATS = ("_mean", "_variance")


def run_steps(device, dtype, sd, batches, classes, lr):
    """The steps from ``sd`` on ``device`` in ``dtype``. Returns the losses
    and the state after them, as numpy f64 in the reference's names."""
    model = pt.vision.resnet50(num_classes=classes, device=device)
    load_reference_state_dict(model, sd)
    model.to(dtype=dtype)
    opt = pt.optimizer.Momentum(lr, 0.9, parameters=model.parameters(),
                                weight_decay=pt.regularizer.L2Decay(1e-4))
    ce = pt.nn.CrossEntropyLoss(label_smoothing=0.1)
    step = TrainStep(model, opt, lambda o, t: ce(o, t))
    losses = [float(step(torch.from_numpy(x).to(device, dtype),
                         torch.from_numpy(y).to(device)))
              for x, y in batches]
    state = {k: np.asarray(v, np.float64)
             for k, v in export_reference_state_dict(model).items()}
    return losses, state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[16, 3, 224, 224])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=5,
                    help="tensors to list per pair, worst first")
    args = ap.parse_args(argv)
    pt.seed(args.seed)
    init = pt.vision.resnet50(num_classes=args.classes, device="cpu")
    sd = {k: np.asarray(v) for k, v in
          export_reference_state_dict(init).items()}
    rng = np.random.RandomState(args.seed)
    batches = [(rng.rand(*args.shape).astype(np.float32),
                rng.randint(0, args.classes, args.shape[:1]).astype(np.int64))
               for _ in range(args.steps)]
    runs = {}
    plan = [("cpu f64", "cpu", torch.float64), ("cpu f32", "cpu",
                                                torch.float32)]
    if torch.cuda.is_available():
        plan.append(("card f32", "cuda", torch.float32))
        print("card:", torch.cuda.get_device_name(0))
    for name, device, dtype in plan:
        t0 = time.perf_counter()
        runs[name] = run_steps(torch.device(device), dtype, sd, batches,
                               args.classes, args.lr)
        print(f"{name}: losses {runs[name][0]} "
              f"({time.perf_counter() - t0:.1f} s)")
    exact = runs["cpu f64"][1]
    change = {k: float(np.abs(v - np.asarray(sd[k], np.float64)).max())
              for k, v in exact.items()}
    print(f"ResNet-50, {args.steps} steps at {args.shape}, lr {args.lr}, "
          f"{args.classes} classes, seed {args.seed}: max |a - b| / "
          "max |change| per tensor")
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (la, sa), (lb, sb) = runs[a], runs[b]
            loss_rel = max(abs(p - q) / abs(q) for p, q in zip(la, lb))
            print(f"  {a} vs {b}: loss relative {loss_rel:.3e}")
            for kind, keys in (("weights", [k for k in exact if not
                                            k.endswith(STATS)]),
                               ("BN running stats", [k for k in exact
                                                     if k.endswith(STATS)])):
                ratio = {k: float(np.abs(sa[k] - sb[k]).max())
                         / max(change[k], 1e-30) for k in keys}
                worst = sorted(ratio.items(), key=lambda kv: -kv[1])
                print(f"    {kind}: worst {worst[0][1]:.3e} ({worst[0][0]}),"
                      f" median {float(np.median(list(ratio.values()))):.3e};"
                      " " + ", ".join(f"{k} {r:.3e}"
                                      for k, r in worst[:args.top]))

if __name__ == "__main__":
    main()
