"""GraphGPS's attention kernels (csrc/gps_attention.cu) on the card against
their plain versions, and the model's train step on the card.

* ``gps_attention_forward`` / ``_backward`` against
  ``gps_attention_forward_plain`` / ``_backward_plain`` on the same card
  tensors: units of 1, 15, 16, 17, 2,338 and 5,000 rows alone, a mixed
  batch with an empty unit, units across the forward's 128-row tile and
  64-row stage and the backward's 256-key tile and 32-query stage, and a
  batch whose units are not in size order (the backward runs them largest
  first), and a batch of 72 units, enough to fill the card without
  cutting the units' keys into ranges (the other batches are cut); 4
  heads of 16; without dropout and at rate 0.5 (the same masks: the
  kernels' hash equals ``attention_keep_plain``); two runs bitwise equal,
  on the mixed batch, the 5,000-row unit and the 72 units;
* the wrappers' launch counts (one forward call, one backward call, each a
  counted call), a batch of only empty units (no launch), and the
  backward's two kernels in the profiler's trace (exactly two launches
  named ``gps_attn_bwd...``, which the benchmark's roofline reads);
* two GraphGPS train steps on a batch of units on the card from one state
  bitwise equal, with no host synchronisation inside a step, and one
  step against the CPU's (the model at 2 layers, no dropout outside the
  attention; the zoo's bitwise test in tests/test_torch_cuda.py runs it at
  0.2 on one graph).

Every test is ``cuda``-marked and skips where no GPU is present (run with
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda*.py``).

Tolerances: the kernels sum a row's keys in chunks of 16 with an online
softmax, in exp2 (the SFU's ``ex2.approx``, 2 ulp), where the plain version
takes one max and ``exp``, and matrix products in another order; over up
to 5,000 keys that moves an output by a few 1e-7 of its scale and a
gradient by a few 1e-6: ``rtol=1e-4, atol=1e-5`` holds both with room.
"""
import copy
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.models.zoo import get_model
from gnnome_tpu_torch.ops import kernels as K
from gnnome_tpu_torch.train.step import (batch_units, example_from_unit,
                                         host_units, make_optimizer,
                                         train_step)
from torch_recipes import cuda  # noqa: F401  (the fixture)

pytestmark = pytest.mark.cuda

HEADS = 4
LENGTHS = {"one": [1], "fifteen": [15], "sixteen": [16], "seventeen": [17],
           "large": [2338], "long": [5000],
           "mixed": [1, 15, 0, 16, 17, 63, 64, 65, 127, 128, 129, 300, 2338],
           "unsorted": [300, 33, 2338, 0, 257, 5000, 1, 512, 31],
           "many": [1, 31, 32, 33, 255, 256, 257, 513, 0, 90] * 8}
RTOL, ATOL = 1e-4, 1e-5


def _case(lengths, device, seed=0):
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    seg = K.AttentionSegments(ptr, device)
    gen = torch.Generator().manual_seed(seed)
    n = int(ptr[-1])
    qkv = torch.randn(n, 3 * HEADS * 16, generator=gen).to(device)
    d_out = torch.randn(n, HEADS * 16, generator=gen).to(device)
    s = torch.tensor([-(2 ** 62) + 12345 * (seed + 1)], dtype=torch.int64,
                     device=device)
    return seg, qkv, d_out, s


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_kernels_against_plain(cuda, case, rate):
    seg, qkv, d_out, seed = _case(LENGTHS[case], cuda)
    out, lse = K.gps_attention_forward(qkv, seg, seed, 3, HEADS, rate)
    p_out, p_lse = K.gps_attention_forward_plain(qkv, seg, seed, 3, HEADS,
                                                 rate)
    torch.testing.assert_close(out, p_out, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(lse, p_lse, rtol=RTOL, atol=ATOL)
    d_qkv = K.gps_attention_backward(qkv, out, lse, d_out, seg, seed, 3,
                                     HEADS, rate)
    p_d = K.gps_attention_backward_plain(qkv, p_out, p_lse, d_out, seg, seed,
                                         3, HEADS, rate)
    torch.testing.assert_close(d_qkv, p_d, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", ["mixed", "long", "many"])
def test_two_runs_bitwise_equal(cuda, case, rate):
    seg, qkv, d_out, seed = _case(LENGTHS[case], cuda, seed=3)
    runs = []
    for _ in range(2):
        out, lse = K.gps_attention_forward(qkv, seg, seed, 1, HEADS, rate)
        runs.append((out, lse, K.gps_attention_backward(
            qkv, out, lse, d_out, seg, seed, 1, HEADS, rate)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_dropout_masks_the_plain_ones(cuda):
    """With v one-hot over the keys, the kernel's output is the dropped
    weights: zero exactly where ``attention_keep_plain`` drops."""
    n = 40
    seg = K.AttentionSegments([0, n], cuda)
    qkv = torch.zeros(n, 3 * HEADS * 16, device=cuda)
    qkv[:, :2 * HEADS * 16] = torch.randn(n, 2 * HEADS * 16, device=cuda)
    for h in range(HEADS):
        qkv[:16, 2 * HEADS * 16 + 16 * h:2 * HEADS * 16 + 16 * (h + 1)] = \
            torch.eye(16, device=cuda)
    seed = torch.tensor([987654321987], dtype=torch.int64, device=cuda)
    out, _ = K.gps_attention_forward(qkv, seg, seed, 2, HEADS, 0.5)
    keep = K.attention_keep_plain(987654321987, 2, HEADS, n, n, 0.5)
    got = out.view(n, HEADS, 16).transpose(0, 1).cpu() != 0
    assert torch.equal(got, keep[:, :, :16])


def test_launches_and_empty_units(cuda):
    seg, qkv, d_out, seed = _case([5, 0, 7], cuda)
    K.reset_launch_counts()
    out, lse = K.gps_attention_forward(qkv, seg, seed, 0, HEADS, 0.5)
    K.gps_attention_backward(qkv, out, lse, d_out, seg, seed, 0, HEADS, 0.5)
    counts = K.launch_counts()
    assert counts["gps_attention_forward"] == 1
    assert counts["gps_attention_backward"] == 1
    assert sum(counts.values()) == 2
    empty = K.AttentionSegments([0, 0, 0], cuda)
    qkv0 = torch.zeros(0, 3 * HEADS * 16, device=cuda)
    K.reset_launch_counts()
    out, lse = K.gps_attention_forward(qkv0, empty, seed, 0, HEADS, 0.5)
    assert out.shape == (0, HEADS * 16) and lse.shape == (0, HEADS)
    assert K.gps_attention_backward(qkv0, out, lse, out, empty, seed, 0,
                                    HEADS, 0.5).shape == qkv0.shape
    assert sum(K.launch_counts().values()) == 0


_PROFILE_BACKWARD = r"""
import json
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from gnnome_tpu_torch.ops import kernels as K

lengths = [300, 33, 2338, 0, 257, 5000, 1, 512, 31]
ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
dev = torch.device("cuda")
seg = K.AttentionSegments(ptr, dev)
gen = torch.Generator(device=dev).manual_seed(4)
qkv = torch.randn(int(ptr[-1]), 192, device=dev, generator=gen)
d_out = torch.randn(int(ptr[-1]), 64, device=dev, generator=gen)
seed = torch.tensor([4], dtype=torch.int64, device=dev)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    out, lse = K.gps_attention_forward(qkv, seg, seed, 0, 4, 0.5)
    torch.cuda.synchronize()
    K.gps_attention_backward(qkv, out, lse, d_out, seg, seed, 0, 4, 0.5)
    torch.cuda.synchronize()
events = sorted((ev for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", False)),
                key=lambda ev: ev.time_range.start)
print(json.dumps([ev.name for ev in events]))
"""


def test_backward_launches_two_named_kernels(cuda):
    """One backward call is two launches, both named ``gps_attn_bwd...``
    (``benchmarks/metrics/attn_bwd_roofline.gps.py`` reads at two a layer
    a step): the rowdot kernel, then the fused pass.  Profiled as the
    benchmark traces a cell, in a process of its own (a long process's
    earlier profiler sessions can leave a session's device recording
    without its first launches, or empty), host and device activities,
    the forward first."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", _PROFILE_BACKWARD], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    names = json.loads(p.stdout.strip().splitlines()[-1])
    bwd = [re.search(r"\bgps_attn_bwd\w*", nm) for nm in names]
    assert [m.group() for m in bwd if m] == ["gps_attn_bwd_rowdot_kernel",
                                             "gps_attn_bwd_kernel"], names
    assert all("gps_attn_" in nm for nm in names), names


def _gps_setup(device):
    cfg = Config()
    cfg.model.model = "graphgps"
    cfg.model.num_gnn_layers = 2
    cfg.model.dropout = 0.0
    cfg.train.use_symmetry_loss = False
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 60
    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=25000,
                                          read_len=400, seed=13)
    units = host_units(g, cfg, np.random.default_rng(0), shuffle_parts=False)
    unit = batch_units(units)
    model = get_model(cfg.model).init_weights(7)
    return cfg, unit, model


def _step(cfg, unit, model, device):
    """One step's loss, logits and gradients, on the host."""
    ex = example_from_unit(unit, device, cfg.model)
    model = copy.deepcopy(model).to(device)
    opt = make_optimizer(model, 1e-3)
    gen = torch.Generator(device=device).manual_seed(5)
    loss, logits = train_step(model, opt, ex, 1.0, cfg, gen)
    return (float(loss), logits.cpu(),
            {n: p.grad.cpu() for n, p in model.named_parameters()})


def test_train_steps_bitwise_and_without_sync(cuda):
    """Two steps on a batch of units from one state, bit for bit, with the
    attention's launches, never waiting for the device."""
    cfg, unit, model = _gps_setup(cuda)
    ex = example_from_unit(unit, cuda, cfg.model)
    models = [copy.deepcopy(model).to(cuda) for _ in range(2)]
    opts = [make_optimizer(m, 1e-3) for m in models]
    gens = [torch.Generator(device=cuda).manual_seed(5) for _ in range(2)]
    K.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [train_step(m, o, ex, 1.0, cfg, g)[0]
                  for m, o, g in zip(models, opts, gens)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(losses[0], losses[1])
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(a, b), k
    counts = K.launch_counts()
    assert counts["gps_attention_forward"] == 2 * 2
    assert counts["gps_attention_backward"] == 2 * 2
    assert counts["bn_residual_forward"] == 2 * 2 * 3


def test_train_step_against_the_cpu(cuda):
    """One step on the card against the CPU's, without attention dropout
    (the seeds come from each device's generator, which differ): loss,
    logits and every gradient, each tensor within 1e-3 of max(its largest
    entry, the median tensor's) (float32 sums in other orders through two
    layers and five BatchNorms a layer; a bias before a BatchNorm has a
    gradient of round-off alone, so its own largest entry is no scale)."""
    cfg, unit, model = _gps_setup(cuda)
    cfg.model.gps_attn_dropout = model.attn_dropout = 0.0
    loss, logits, grads = _step(cfg, unit, model, cuda)
    want_loss, want_logits, want = _step(cfg, unit, model, "cpu")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    torch.testing.assert_close(logits, want_logits, rtol=0,
                               atol=1e-4 * float(want_logits.abs().max()))
    big = {k: float(v.abs().max()) for k, v in want.items()}
    med = float(np.median(list(big.values())))
    for k, v in want.items():
        torch.testing.assert_close(grads[k], v, rtol=0,
                                   atol=1e-3 * max(big[k], med), msg=k)
