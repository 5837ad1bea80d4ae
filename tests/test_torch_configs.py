"""The shipped LSNet configs through the port's builders.

Every ``configs/lsnet/*.py`` file is read with the JAX package's config
loader (``lsnet_tpu.utils.config.Config``: the test may import it, the
port may not) and its ``model`` dict goes to the port's ``build_detector``
on the ``meta`` device (no weights are allocated). The R50 and X-101
files build, ``with_cp=True`` included; the Res2Net backbone and the CPV
detector are not ported yet and raise ``NotImplementedError`` naming them.

``with_cp`` runs each residual block under ``torch.utils.checkpoint``
(``remat`` in the JAX package): a narrow ResNeXt with DCN stages gives the
same loss and gradients with and without it (f32, 1e-6 of max(1, max|ref|):
the recomputed forward repeats the same operations), and the block's
forward runs a second time in the backward only when training with
gradients on.
"""

import glob
import os

import numpy as np
import pytest
import torch

from lsnet_tpu.utils.config import Config
from lsnet_torch.models import build_detector
from lsnet_torch.models.backbones.resnet import ResNet
from lsnet_torch.ops.flat_deform import TRAIN_SAMPLING

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "configs", "lsnet", "*.py")))


def _model_cfg(name):
    return Config.fromfile(os.path.join(REPO, "configs", "lsnet",
                                        name)).to_dict()["model"]


def test_every_lsnet_config_is_listed():
    """17 files: 6 R50, 7 X-101 and 4 Res2Net-101, one of each of the
    last two with the CPV head."""
    assert len(CONFIGS) == 17
    assert sum("r50" in n for n in CONFIGS) == 6
    assert sum("x101" in n for n in CONFIGS) == 7
    assert sum("cpv" in n for n in CONFIGS) == 2


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_or_names_what_is_missing(name):
    cfg = _model_cfg(name)
    if "cpv" in name:
        missing = "LSCPVDetector"
    elif "res2" in name:
        missing = "Res2Net"
    else:
        missing = None
    if missing:
        with pytest.raises(NotImplementedError, match=missing):
            with torch.device("meta"):
                build_detector(cfg)
        return
    with torch.device("meta"):
        model = build_detector(cfg)
    backbone = cfg["backbone"]
    assert model.backbone.with_cp == bool(backbone.get("with_cp", False))
    if "dconv" in name:
        assert backbone["with_cp"] and backbone["type"] == "ResNeXt"
    assert sum(p.numel() for p in model.head.parameters()) > 0


def _narrow_resnext(with_cp):
    return ResNet(depth=50, block_type="resnext", groups=4, base_width=4,
                  stage_with_dcn=(False, True, True, True), frozen_stages=1,
                  with_cp=with_cp)


def _loss_and_grads(model, image, probe):
    outs = model(image, TRAIN_SAMPLING)
    loss = sum((o * p).sum() for o, p in zip(outs, probe))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(
        loss, [p for p in model.parameters() if p.requires_grad])
    return loss.detach(), dict(zip(names, grads))


def test_with_cp_gives_the_same_loss_and_gradients():
    torch.manual_seed(0)
    ref = _narrow_resnext(False).train()
    cp = _narrow_resnext(True).train()
    cp.load_state_dict(ref.state_dict())
    rng = np.random.RandomState(0)
    image = torch.from_numpy(rng.randn(2, 3, 64, 96).astype(np.float32))
    with torch.no_grad():
        shapes = [o.shape for o in ref(image, TRAIN_SAMPLING)]
    probe = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in shapes]

    calls = []
    hook = cp.layer2_0.register_forward_pre_hook(lambda *_: calls.append(1))
    want_loss, want = _loss_and_grads(ref, image, probe)
    got_loss, got = _loss_and_grads(cp, image, probe)
    assert len(calls) == 2          # the forward, and its recompute
    hook.remove()

    assert abs(got_loss.item() - want_loss.item()) <= 1e-6 * max(
        1.0, abs(want_loss.item()))
    assert got.keys() == want.keys() and len(want) > 0
    for name, g in want.items():
        lim = 1e-6 * max(1.0, g.abs().max().item())
        assert (got[name] - g).abs().max().item() <= lim, name


def test_with_cp_is_off_without_gradients_or_training():
    model = _narrow_resnext(True)
    calls = []
    model.layer3_0.register_forward_pre_hook(lambda *_: calls.append(1))
    image = torch.randn(1, 3, 32, 32)
    with torch.no_grad():
        model.train()(image)
    model.eval()
    model(image)[-1].sum().backward()
    assert len(calls) == 2          # once per forward, no recompute
