"""FLOPs of a forward pass (counterpart of ``paddle_tpu/hapi/flops.py``
``paddle.flops``).

The reference asks XLA's cost model about the compiled forward. Here the
forward runs once without data (``FakeTensorMode``: the parameters and
inputs become fake tensors, nothing is computed or written) under
``torch.utils.flop_counter``, which counts 2 FLOPs per multiply-add of
every matrix product and convolution; the port's attention op counts its
two products in full (``kernels.attention``). Elementwise work, pooling
and normalisation, which XLA also counts, are left out: a model's count
is its products'."""
from __future__ import annotations

import torch

__all__ = ["flops"]


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False):
    """Total forward-pass FLOPs of ``net`` (in eval mode) for a float32
    input of shape ``input_size`` ([N, ...]) or for ``inputs`` (a tensor
    or a list of them), on the device of ``net``'s first parameter.
    ``custom_ops`` is taken in the reference's place and, as there, not
    read."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    del custom_ops
    params = list(net.parameters())
    device = params[0].device if params else torch.device("cpu")
    if inputs is not None:
        xs = [torch.as_tensor(x) for x in
              (inputs if isinstance(inputs, (list, tuple)) else [inputs])]
    elif input_size is None:
        raise ValueError("pass input_size or inputs")
    from ..jit.bridge import faked
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad(), \
                FakeTensorMode(allow_non_fake_inputs=True) as mode, \
                faked(net, mode):
            if inputs is None:
                xs = [torch.zeros(tuple(int(s) for s in input_size),
                                  dtype=torch.float32, device=device)]
            else:
                xs = [mode.from_tensor(x) for x in xs]
            with FlopCounterMode(display=False) as counter:
                net(*xs)
        total = int(counter.get_total_flops())
    finally:
        net.train(was_training)
    if print_detail:
        print(f"Total Flops: {total}  (2 a multiply-add of every matrix "
              "product and convolution of the forward)")
    return total
