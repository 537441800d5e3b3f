"""The port's layer4 weight gradient of the SCL loss against central finite
differences of its own loss, at 64 px, where layer4's maps are 2 x 2 and
its batch-statistic BatchNorms normalise over only 4 positions a frame.

The whole CARL step runs in fp64 on the CPU: the model is cast to double
and `Tensor.float()`, which the port calls where it hands features to the
embedder and embeddings to the loss, keeps fp64 tensors in fp64 for the
test (fp32 there would put ~1e-7 of rounding into a loss differenced over
a step of 1e-6). The frozen trunk's output does not depend on layer4, so it
is computed once and reused by every evaluation.

layer4's BatchNorm scales and shifts are drawn away from their init (1
and 0). At the init, a channel whose batch variance is far below the BN's
eps normalises to values within ~1e-9 of 0, on the kink of the ReLU that
follows (5.6e-10 in block 1 with this seed): no finite difference is valid
there, whatever the step, and the loss is not differentiable at such a
point. Away from the init no pre-activation of layer4 lies within 1e-6 of
0, and the differences agree with the gradient to ~1e-9 of its largest
value.
"""

import numpy as np
import pytest
import torch

from video_rep_learning_tpu_torch.algos import SCL
from video_rep_learning_tpu_torch.config import get_cfg
from video_rep_learning_tpu_torch.models import build_model, set_trainable

torch.set_num_threads(1)

S, T = 64, 6
STEP = 1e-6  # central-difference step, on weights of order 1e-2
# fp64 central differences at STEP: truncation ~STEP^2 of the third
# derivative, rounding ~1e-16 |loss| / STEP ~ 1e-10; the gradient is held to
# 1e-6 of the tensor's largest gradient (measured: ~1e-9; a step across a
# ReLU kink, as at the init, shows as 2e-4 to 7e-4)
REL_TOL = 1e-6
SAMPLES = 4  # weights checked a tensor


def _cfg():
    cfg = get_cfg()
    cfg.IMAGE_SIZE = S
    cfg.TRAIN.NUM_FRAMES = T
    cfg.USE_AMP = False
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 2 * T
    e = cfg.MODEL.EMBEDDER_MODEL
    e.NUM_LAYERS = 1
    e.FC_LAYERS = [[32, True], [32, True]]
    e.CAPACITY_SCALAR = 1
    e.HIDDEN_SIZE = 32
    e.NUM_HEADS = 2
    e.D_FF = 32
    e.EMBEDDING_SIZE = 16
    e.FC_DROPOUT_RATE = 0.0
    cfg.MODEL.PROJECTION_SIZE = 16
    return cfg


def _batch(rng):
    # frames that differ in colour and contrast, so the batch-statistic BNs
    # of layer4 and the head see well-spread features
    videos = (rng.randn(1, 2, T, S, S, 3) * rng.uniform(0.2, 2.0, (1, 2, T, 1, 1, 1))
              + rng.randn(1, 2, T, 1, 1, 3) * 1.5)
    masks = np.ones((1, 2, T))
    masks[0, 1, -2:] = 0
    steps = np.stack([np.sort(rng.choice(20, T, replace=False)) for _ in range(2)])
    return {"videos": torch.from_numpy(videos),
            "video_masks": torch.from_numpy(masks),
            "seq_lens": torch.tensor([[20, 20]], dtype=torch.int32),
            "chosen_steps": torch.from_numpy(steps[None].astype(np.int32))}


@pytest.fixture
def fp64_float(monkeypatch):
    to_fp32 = torch.Tensor.float

    def keep_fp64(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else to_fp32(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "float", keep_fp64)


def test_layer4_weight_gradient_matches_finite_differences(fp64_float, monkeypatch):
    cfg = _cfg()
    torch.manual_seed(0)
    model = build_model(cfg).double()
    named = dict(set_trainable(model, cfg.MODEL.TRAIN_BASE))
    model.train()
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    with torch.no_grad():
        for m in model.res_finetune.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.weight.shape)))
                m.bias.copy_(torch.from_numpy(0.2 * rng.randn(*m.bias.shape)))
    trunk = model._run_frozen(batch["videos"].flatten(0, 2).permute(0, 3, 1, 2))
    monkeypatch.setattr(model, "_run_frozen", lambda frames: trunk)
    algo = SCL(cfg)

    def loss():
        return algo.compute_loss(model, batch)["loss"]

    pre = []  # layer4's pre-activations, the distance of each from its kink
    hooks = [m.register_forward_pre_hook(lambda mod, args: pre.append(args[0].abs().min()))
             for m in model.res_finetune.modules() if isinstance(m, torch.nn.ReLU)]
    out = loss()
    for h in hooks:
        h.remove()
    assert out.dtype == torch.float64 and min(pre).item() > STEP
    out.backward()
    assert loss().item() == out.item()  # deterministic: no dropout, batch BN
    layer4 = {n: p for n, p in named.items() if n.startswith("res_finetune.")}
    # the first conv of layer4, a BN scale of its second block, its last conv
    names = [n for n in layer4 if n.endswith("conv1.weight")][:1] + [
        n for n in layer4 if n.endswith("bn2.weight")][1:2] + [
        n for n in layer4 if n.endswith("conv3.weight")][-1:]
    assert len(names) == 3, sorted(layer4)
    with torch.no_grad():
        for name in names:
            p = layer4[name]
            grad = p.grad.detach().clone()
            top = int(grad.abs().argmax())
            for i in [top] + rng.choice(p.numel(), SAMPLES - 1, replace=False).tolist():
                at = tuple(int(j) for j in np.unravel_index(i, p.shape))
                w = p[at].item()
                p[at] = w + STEP
                up = loss().item()
                p[at] = w - STEP
                down = loss().item()
                p[at] = w
                fd = (up - down) / (2 * STEP)
                err = abs(fd - grad[at].item())
                assert err <= REL_TOL * grad.abs().max().item(), (name, at, fd, err)
