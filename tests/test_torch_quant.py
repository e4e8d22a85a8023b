"""Weight-only quantization of the port (``paddle_tpu_torch/nn/quant.py``)
against the reference's (``paddle_tpu/nn/quant.py``) on the CPU.

The same [in, out] f32 weight (numpy, from a seed) goes through both:
the int8 / int4 codes must be equal bit for bit, the scales within rtol
1e-6 (both are one f32 division of the same absmax), dequantized
weights and ``weight_only_linear`` / ``llm_int8_linear`` outputs within
atol = rtol = 1e-5 (f32 products summed in other orders).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import quant as pq

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [("weight_only_int8", (16, 12), -1), ("weight_only_int8", (16, 12), 2),
         ("weight_only_int8", (16, 12), 4), ("weight_only_int8", (15, 10), -1),
         ("weight_only_int4", (16, 12), -1), ("weight_only_int4", (16, 12), 2),
         ("weight_only_int4", (16, 12), 4), ("weight_only_int4", (15, 10), -1)]


@pytest.fixture(scope="module")
def ref():
    import paddle_tpu as paddle
    from paddle_tpu.nn import quant
    return paddle, quant


def _np(t):
    return np.asarray(t.numpy())


@pytest.mark.parametrize("algo,shape,group", CASES)
def test_codes_scales_and_dequant_match_reference(ref, algo, shape, group):
    paddle, rq = ref
    w = np.random.RandomState(sum(shape) + group).randn(*shape) \
        .astype(np.float32)
    rcode, rscale = rq.weight_quantize(paddle.to_tensor(w), algo=algo,
                                       group_size=group)
    code, scale = pq.weight_quantize(torch.from_numpy(w), algo=algo,
                                     group_size=group)
    assert code.dtype == torch.int8
    np.testing.assert_array_equal(code.numpy(), _np(rcode))
    np.testing.assert_allclose(scale.numpy(), _np(rscale), rtol=1e-6, atol=0)
    want = _np(rq.weight_dequantize(rcode, rscale, algo=algo,
                                    group_size=group))
    got = pq.weight_dequantize(code, scale, algo=algo, group_size=group)
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    # the round trip stays within half a step of the weight
    step = np.repeat(scale.numpy(), group, axis=0) if group != -1 \
        else np.broadcast_to(scale.numpy(), w.shape)
    np.testing.assert_array_less(
        np.abs(got.numpy()[:shape[0]] - w), step * 0.5 + 1e-6)


@pytest.mark.parametrize("algo,shape,group", CASES)
def test_weight_only_linear_matches_reference(ref, algo, shape, group):
    paddle, rq = ref
    rng = np.random.RandomState(7 + shape[0])
    w = rng.randn(*shape).astype(np.float32)
    x = rng.randn(3, 2, shape[0]).astype(np.float32)
    b = rng.randn(shape[1]).astype(np.float32)
    dt = "int4" if algo.endswith("int4") else "int8"
    rcode, rscale = rq.weight_quantize(paddle.to_tensor(w), algo=algo,
                                       group_size=group)
    code, scale = pq.weight_quantize(torch.from_numpy(w), algo=algo,
                                     group_size=group)
    want = _np(rq.weight_only_linear(paddle.to_tensor(x), rcode,
                                     bias=paddle.to_tensor(b),
                                     weight_scale=rscale, weight_dtype=dt,
                                     group_size=group))
    got = pq.weight_only_linear(torch.from_numpy(x), code,
                                bias=torch.from_numpy(b), weight_scale=scale,
                                weight_dtype=dt, group_size=group)
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)


def test_llm_int8_linear_matches_reference(ref):
    paddle, rq = ref
    rng = np.random.RandomState(3)
    w = rng.randn(24, 8).astype(np.float32)
    x = rng.randn(5, 24).astype(np.float32)
    rcode, rscale = rq.weight_quantize(paddle.to_tensor(w), algo="llm.int8")
    code, scale = pq.weight_quantize(torch.from_numpy(w), algo="llm.int8")
    np.testing.assert_array_equal(code.numpy(), _np(rcode))
    want = _np(rq.llm_int8_linear(paddle.to_tensor(x), rcode,
                                  weight_scale=rscale))
    got = pq.llm_int8_linear(torch.from_numpy(x), code, weight_scale=scale)
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)


@pytest.mark.parametrize("group", [1, 3, 5, 0])
def test_bad_group_sizes_raise(group):
    w = torch.randn(16, 4)
    with pytest.raises(ValueError, match="group_size"):
        pq.weight_quantize(w, group_size=group)


def test_bad_algo_and_group_mismatch_raise():
    w = torch.randn(16, 4)
    with pytest.raises(ValueError, match="algo"):
        pq.weight_quantize(w, algo="fp4")
    code, scale = pq.weight_quantize(w, group_size=4)
    with pytest.raises(ValueError, match="group_size"):
        pq.weight_dequantize(code, scale, group_size=8)
    with pytest.raises(ValueError, match="weight_scale"):
        pq.weight_only_linear(torch.randn(2, 16), code)
