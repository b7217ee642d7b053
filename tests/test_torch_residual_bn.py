"""The residual training-mode BatchNorm ``models/norm.residual_batch_norm``
(one autograd Function over ``ops/kernels.bn_residual_forward`` /
``bn_residual_backward``, whose CUDA kernels are csrc/bn_residual.cu) on
the CPU, where the wrappers take their plain versions: the forward is
``apply_norm(bn, a + b)`` bit for bit, with the same running statistics
and ``num_batches_tracked``; the closed-form backward matches autograd's
through ``apply_norm`` and passes ``gradcheck`` in float64; no rows
raises, forward and backward; and the Graph Transformer layer takes the
Function only for a training-mode BatchNorm of float32 rows
(``apply_norm`` in eval, for layer norm and none, and in float64).  The kernels against these plain versions
on the card: ``tests/test_torch_cuda.py``."""
import copy

import numpy as np
import pytest
import torch
from torch import nn

from gnnome_tpu_torch.models import zoo
from gnnome_tpu_torch.models.norm import (_ResidualBatchNorm, apply_norm,
                                          residual_batch_norm)
from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.ops import kernels as K

# rows, width: the model's 64, a width of one float a thread on the card,
# two rows, and one row (variance 0, no unbiased correction)
CASES = [(1000, 64), (37, 20), (2, 8), (1, 6)]


def _inputs(n, d, seed, dtype=torch.float32, far: bool = True):
    """A training-mode BatchNorm with drawn weight, bias and running
    statistics, and residual halves ``a`` (``far``: column means up to 1e3,
    so the variance is taken about a far mean; else up to 1) and ``b``."""
    gen = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm1d(d).to(dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(d, generator=gen, dtype=dtype) + 0.5)
        bn.bias.copy_(torch.randn(d, generator=gen, dtype=dtype))
        bn.running_mean.copy_(torch.randn(d, generator=gen, dtype=dtype))
        bn.running_var.copy_(torch.rand(d, generator=gen, dtype=dtype) + 0.5)
        bn.num_batches_tracked.fill_(3)
    shift = torch.logspace(-1, 3 if far else 0, d, dtype=dtype)
    a = torch.randn(n, d, generator=gen, dtype=dtype) * 2.0 + shift
    b = torch.randn(n, d, generator=gen, dtype=dtype)
    return bn, a, b


@pytest.mark.parametrize("n,d", CASES)
def test_forward_is_apply_norm_of_the_sum(n, d):
    bn, a, b = _inputs(n, d, seed=n + d)
    ref = copy.deepcopy(bn)
    y = residual_batch_norm(bn, a, b)
    assert torch.equal(y, apply_norm(ref, a + b))
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn, name), getattr(ref, name)), name
    assert int(bn.num_batches_tracked) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,d", CASES[:3])
def test_backward_matches_autograd_through_apply_norm(n, d, dtype):
    """The closed-form backward against autograd's passes through
    ``batch_norm_train``: float32 within rounding of a few operations on
    values of order 1 (1e-5; column means up to 1, as a far mean rounds
    x - mean to the spacing of x in both), float64 within 1e-12 with means
    up to 1e3."""
    f32 = dtype == torch.float32
    bn, a, b = _inputs(n, d, seed=7, dtype=dtype, far=not f32)
    ref = copy.deepcopy(bn)
    a, b = a.requires_grad_(), b.requires_grad_()
    ra, rb = a.detach().clone().requires_grad_(), b.detach().clone(
        ).requires_grad_()
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(8),
                    dtype=dtype)
    residual_batch_norm(bn, a, b).backward(g)
    apply_norm(ref, ra + rb).backward(g)
    tol = 1e-5 if f32 else 1e-12
    assert torch.equal(a.grad, b.grad)
    for got, want in ((a.grad, ra.grad), (bn.weight.grad, ref.weight.grad),
                      (bn.bias.grad, ref.bias.grad)):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d", [(7, 5), (12, 3), (2, 4)])
def test_gradcheck_float64(n, d):
    bn, a, b = _inputs(n, d, seed=n, dtype=torch.float64)
    args = (a.requires_grad_(), b.requires_grad_(), bn.weight, bn.bias)
    assert torch.autograd.gradcheck(
        lambda a, b, w, c: _ResidualBatchNorm.apply(a, b, w, c, bn), args)


def test_no_rows_raises_and_changes_nothing():
    bn, a, b = _inputs(0, 8, seed=1)
    ref = copy.deepcopy(bn)
    with pytest.raises(ValueError):
        residual_batch_norm(bn, a, b)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn, name), getattr(ref, name)), name
    assert K.launch_counts()["bn_residual_forward"] == 0


def test_backward_on_no_rows_raises():
    """The forward takes no empty batch, so its adjoint has none either."""
    _, x, _ = _inputs(0, 8, seed=2)
    stats = torch.stack([torch.zeros(8), torch.ones(8)])
    with pytest.raises(ValueError):
        K.bn_residual_backward(x, x, stats, torch.ones(8))
    assert K.launch_counts()["bn_residual_backward"] == 0


# ------------------------------------------------- the Graph Transformer
LAYER_D, LAYER_HEADS = 16, 4


def _layer_run(monkeypatch, normalization, training, dtype,
               route: bool = True):
    """One ``_GTLayer`` forward and backward on a small graph: ``(calls,
    outputs, gradients)``, ``calls`` the norms through the Function and
    through ``apply_norm``; ``route=False`` sends every norm through
    ``apply_norm(norm, a + b)``."""
    calls = {"function": 0, "apply_norm": 0}

    def function(norm, a, b):
        calls["function"] += 1
        return residual_batch_norm(norm, a, b)

    def apply(norm, x):
        calls["apply_norm"] += 1
        return apply_norm(norm, x)

    monkeypatch.setattr(zoo, "residual_batch_norm", function)
    monkeypatch.setattr(zoo, "apply_norm", apply)
    if not route:
        monkeypatch.setattr(zoo, "_residual_norm",
                            lambda norm, a, b: apply(norm, a + b))
    rng = np.random.default_rng(0)
    n = 40
    src, dst = rng.integers(0, n, 150), rng.integers(0, n, 150)
    g = DeviceGraph.build(src, dst, n)
    torch.manual_seed(0)
    layer = zoo._GTLayer(LAYER_D, normalization, LAYER_HEADS).to(dtype)
    layer.train(training)
    gen = torch.Generator().manual_seed(1)
    h = torch.randn(n, LAYER_D, generator=gen, dtype=dtype,
                    requires_grad=True)
    e = torch.randn(150, LAYER_D, generator=gen, dtype=dtype,
                    requires_grad=True)
    h1, e1 = layer(g, h, e, 0.0, None)
    (h1.square().sum() + e1.sin().sum()).backward()
    grads = [h.grad, e.grad] + [p.grad for p in layer.parameters()]
    return calls, (h1, e1), grads


@pytest.mark.parametrize("normalization,training,dtype,function", [
    ("batch", True, torch.float32, 4), ("batch", False, torch.float32, 0),
    ("batch", True, torch.float64, 0), ("layer", True, torch.float32, 0),
    ("none", True, torch.float32, 0)])
def test_gt_layer_takes_the_function_only_for_training_batch_norm(
        monkeypatch, normalization, training, dtype, function):
    """Four norms a layer: through the Function for a training-mode
    BatchNorm of float32 rows, else through ``apply_norm`` (eval, layer
    norm, none, float64); the forward the same either way, bit for bit,
    and the gradients within rounding: 1e-6 of the largest gradient
    element (a bias ahead of a BatchNorm has a gradient of zero up to
    rounding, so its own scale is noise; the differences read up to 2e-7
    of it)."""
    calls, out, grads = _layer_run(monkeypatch, normalization, training,
                                   dtype)
    assert calls == {"function": function, "apply_norm": 4 - function}
    ref_calls, ref_out, ref_grads = _layer_run(
        monkeypatch, normalization, training, dtype, route=False)
    assert ref_calls == {"function": 0, "apply_norm": 4}
    assert all(torch.equal(a, b) for a, b in zip(out, ref_out))
    scale = max(float(b.abs().max()) for b in ref_grads)
    for a, b in zip(grads, ref_grads):
        if function:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * scale)
        else:
            assert torch.equal(a, b)
