"""User entry points (counterpart of ``lsnet_tpu/apis.py``, the reference's
``mmdet.apis``), for the ``LSDetector`` / ``LSHead``, ``LSCPVDetector``
and RepPoints v1 / v2 configs. A detector decodes with its head's decode
(``train.loop.decode_for``: ``lscpv_decode``'s corner snap for CPV,
``reppoints_decode`` / ``reppoints_v2_decode`` for RepPoints, whose
landmarks are zeros), except in ``aug_test_simple``, which takes LSNet's
candidates as JAX's does and so serves the LSNet heads only. The dense
zoo's RetinaNet, FCOS, ATSS, GFL and GA-RetinaNet files decode with
``dense_decode`` (zero landmarks). A Dense RepPoints config and a GA-RPN
config are refused by :func:`init_detector`: the JAX API has no decode
for the first and reads ``bbox_head``, which an ``RPN`` lacks; both are
evaluated through ``lsnet_torch.tools.test`` and served by
:func:`detect`.

The image-level API:

* :func:`init_detector` (config file or ``Config``, checkpoint) -> a
  :class:`DetectorBundle` on the card (or on the CPU when the caller asks
  for it), with the sampling the checkpoint deploys (``test_cfg.
  dcn_sampling`` in the config wins) and, optionally, FrozenBatchNorm
  folded into the convs;
* :func:`inference_detector`: one image (a path or an HWC uint8 RGB
  array) -> resize, normalise, pad to a bucket canvas, forward, decode,
  NMS -> numpy ``bboxes`` / ``scores`` / ``labels`` / ``landmarks`` in the
  image's coordinates;
* :func:`aug_test_simple` (candidates of every scale and flip, one
  class-wise NMS) and :func:`aug_test` (multi-scale + flip with the
  IoU-weighted soft vote, on the device);
* :func:`show_result` and :func:`async_inference_detector`;
* ``train_detector`` / ``evaluate_detector``, re-exported from
  :mod:`lsnet_torch.train.loop`.

The tensor-level entries, on batches that are already normalised and
padded: :func:`init_model` (a model config dict -> a detector with seeded
random weights), :func:`detect` (forward + decode + NMS, the path
``bench.py`` times for the JAX package) and :func:`train_detector_step`.
Training and evaluating from a config file and COCO data is the runner's:
``python3 -m lsnet_torch.tools.train`` / ``lsnet_torch.tools.test``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from .core.decode import (Detections, TestConfig, lsnet_decode_candidates,
                          nms_candidates)
from .data.transforms import (canvas_for_scale, normalize_image,
                              pad_to_shape, rescale_size, resize_image)
from .models import build_detector
from .models.detectors.lsnet import LSDetector
from .models.init import init_weights_
from .models.layers import FrozenBatchNorm
from .ops.flat_deform import (INFERENCE_SAMPLING, TRAIN_SAMPLING,
                              sampling_from_spec)
from .train.checkpoint import refine_taps_env, restore_eval_state
from .train.loop import (DENSE_REPPOINTS, decode_for,  # noqa: F401
                         eval_sampling, evaluate_detector, runner_device,
                         test_cfg_from,
                         train_detector)
from .train.optim import build_optimizer
from .train.step import LossCfg, make_train_step
from .utils.config import Config

Image = Union[str, np.ndarray]


# ------------------------------------------------------------ tensor level

def random_weights_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter ~ 0.03 * N(0, 1) from ``seed`` (the scale
    ``bench.py`` mints), FrozenBatchNorm statistics mean 0, var 1. In
    place."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.03 * torch.randn(p.shape, generator=gen))
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.mean.zero_()
                m.var.fill_(1.0)
    return model


def init_model(cfg: Dict[str, Any], device: str = "cuda", seed: int = 0,
               dtype: torch.dtype = torch.float32,
               train: bool = False) -> LSDetector:
    """Build the detector from a ``model`` config dict with seeded random
    weights (:func:`random_weights_`) on ``device`` (the card by default),
    in eval mode or, with ``train=True``, in training mode (FrozenBatchNorm
    normalises with its stored statistics either way; the frozen stages'
    parameters have ``requires_grad=False``)."""
    device = runner_device(device)
    model = random_weights_(build_detector(cfg), seed)
    return model.to(device=device, dtype=dtype).train(train)


def train_detector_step(model: LSDetector, loss_cfg: LossCfg, *,
                        base_lr: float = 0.01, steps_per_epoch: int = 1000,
                        decay_epochs: Sequence[int] = (8, 11),
                        mixed_precision: bool = True,
                        sampling: Mapping[str, str] = TRAIN_SAMPLING,
                        **optim_kwargs
                        ) -> Callable[[Mapping[str, torch.Tensor]],
                                      Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics`` for ``model`` (f32 master weights, from
    ``init_model(..., train=True)``): the reference recipe (SGD 0.9,
    weight decay 1e-4, clip 35, warm-up + step schedule) on the loss of
    ``loss_cfg.task`` (``lscpv_loss`` for a ``CPVLossConfig``, the
    RepPoints family's for its configs: ``train.step.LOSSES``), bf16
    compute unless ``mixed_precision=False``. ``optim_kwargs`` go to
    :func:`lsnet_torch.train.optim.build_optimizer`."""
    optimizer, _ = build_optimizer(model.parameters(), base_lr,
                                   steps_per_epoch, decay_epochs,
                                   **optim_kwargs)
    return make_train_step(model, optimizer, loss_cfg, mixed_precision,
                           sampling)


def detect(model: LSDetector, images: torch.Tensor,
           img_shapes: torch.Tensor, scale_factors: torch.Tensor,
           test_cfg: TestConfig,
           sampling: Mapping[str, str] = INFERENCE_SAMPLING,
           config: Optional[Config] = None) -> Detections:
    """images (B, H, W, 3) NHWC in the model's dtype; img_shapes (B, 2)
    [h, w]; scale_factors (B, 4); ``sampling`` maps each sampling site to
    its mode (``flat_deform.TRAIN_SAMPLING`` for bilinear everywhere).
    Returns padded Detections of the head's decode
    (``train.loop.decode_for``, which needs the model's ``config`` file
    for the RepPoints heads and the dense zoo's)."""
    decode = decode_for(model, config)
    with torch.inference_mode():
        outs = model(images, sampling)
        return decode(outs, img_shapes, scale_factors, test_cfg)


# ------------------------------------------------------------ image level

@dataclass
class DetectorBundle:
    """A detector ready for images: the model (weights on its device and
    dtype), its config, the default canvas and the sampling it runs."""
    model: LSDetector
    cfg: Config
    canvas: Tuple[int, int]
    sampling: Mapping[str, str]
    _fwd_cache: Dict[Tuple[int, int], Callable] = field(
        default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    def fwd_for(self, canvas_hw: Tuple[int, int]
                ) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                              Detections]:
        """Forward + decode for one canvas: ``fwd(images, img_shapes,
        scale_factors) -> Detections`` with the test settings of that
        canvas (cached per canvas, as the JAX bundle caches its jitted
        function)."""
        canvas_hw = tuple(int(v) for v in canvas_hw)
        if canvas_hw not in self._fwd_cache:
            tcfg = test_cfg_from(self.cfg, canvas_hw)

            def fwd(images, img_shapes, scale_factors):
                return detect(self.model, images, img_shapes, scale_factors,
                              tcfg, self.sampling, self.cfg)

            self._fwd_cache[canvas_hw] = fwd
        return self._fwd_cache[canvas_hw]


def bucket_canvas(scale: Tuple[int, int], h: int, w: int,
                  divisor: int = 32) -> Tuple[int, int]:
    """Static canvas bucket for one (long, short) test scale and an input
    orientation: (short, long) for landscape inputs, transposed for
    portrait."""
    return canvas_for_scale(tuple(scale), portrait=h > w, divisor=divisor)


def init_detector(config: Union[str, Config],
                  checkpoint: Optional[str] = None,
                  canvas: Optional[Tuple[int, int]] = None,
                  fuse_conv_bn: bool = False, *, device="cuda",
                  dtype: torch.dtype = torch.float32) -> DetectorBundle:
    """A :class:`DetectorBundle` from a config (a path or a ``Config``)
    and a checkpoint of the runner (``step_N.pt``; strict). Without one
    the weights are the training init (:func:`lsnet_torch.models.init.
    init_weights_`) from seed 0. The sampling is ``test_cfg.dcn_sampling``
    where the config sets it, else what the checkpoint's meta deploys
    (``deploy_sampling``), else ``INFERENCE_SAMPLING``; the refine taps
    are ``LSNET_REFINE_TAPS``'s where it is set, else the checkpoint's
    (``refine_taps_train``). Raises when there
    is no CUDA device, unless ``device="cpu"``, and for a Dense RepPoints
    or a GA-RPN config (no image-level decode; evaluate it with
    ``lsnet_torch.tools.test``, serve it with :func:`detect`)."""
    device = runner_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    if cfg.model.get("bbox_head", {}).get("type") in DENSE_REPPOINTS:
        raise NotImplementedError(
            f"{cfg.model.type}: the image-level API has no Dense RepPoints "
            "decode (neither has the JAX package's); evaluate the config "
            "with python3 -m lsnet_torch.tools.test")
    if cfg.model.get("type") == "RPN":
        raise NotImplementedError(
            "RPN: the image-level API reads model.bbox_head, which a "
            "standalone RPN has not (the JAX package's neither); evaluate "
            "the config with python3 -m lsnet_torch.tools.test, serve it "
            "with apis.detect")
    test = cfg.get("test_cfg") or {}
    if test.get("dcn_gather_quant"):
        raise NotImplementedError("dcn_gather_quant: gather quantisation is "
                                  "not ported (ROADMAP Queue 2)")
    canvas = tuple(canvas or cfg.get("canvas_shape", (800, 1344)))
    model = build_detector(cfg.model.to_dict())
    meta = None
    if checkpoint:
        state, meta = restore_eval_state(checkpoint)
        model.load_state_dict(state, strict=True)
    else:
        init_weights_(model, torch.Generator().manual_seed(0))
    mode = test.get("dcn_sampling")
    sampling = eval_sampling(sampling_from_spec(str(mode)) if mode else None,
                             meta, refine_taps_env())
    if fuse_conv_bn:
        from .train.fuse import fuse_conv_bn as _fuse
        _fuse(model)
    model = model.to(device=device, dtype=dtype).eval()
    return DetectorBundle(model, cfg, canvas, sampling)


def _read(img: Image) -> np.ndarray:
    if isinstance(img, str):
        from PIL import Image as PILImage
        with PILImage.open(img) as im:
            img = np.asarray(im.convert("RGB"))
    return img


def _test_scale(cfg: Config) -> Tuple[int, int]:
    return (tuple(cfg.data.test.get("img_scale", (1333, 800)))
            if "data" in cfg else (1333, 800))


def _on_card(bundle: DetectorBundle, canvas_img: np.ndarray,
             nh: int, nw: int, sf: np.ndarray):
    """(images, img_shapes, scale_factors) of one padded image on the
    bundle's device."""
    dev = bundle.device
    return (torch.from_numpy(canvas_img[None]).to(dev, bundle.dtype),
            torch.tensor([[nh, nw]], dtype=torch.int32, device=dev),
            torch.from_numpy(np.asarray(sf, np.float32)[None]).to(dev))


def _augment(img: np.ndarray, scale, flip: bool):
    """(resized h, w, scale factor, [(flipped?, normalised image)]) of one
    test scale, the flipped copy after the plain one when ``flip``."""
    H, W = img.shape[:2]
    nh, nw = rescale_size(H, W, tuple(scale))
    resized = resize_image(img, (nh, nw))
    sf = np.array([nw / W, nh / H, nw / W, nh / H], np.float32)
    augs = [(f, normalize_image(resized[:, ::-1].copy() if f else resized))
            for f in ([False, True] if flip else [False])]
    return nh, nw, sf, augs


def _result(det: Detections) -> Dict[str, np.ndarray]:
    det = Detections(*(x.cpu().numpy() for x in det))
    valid = det.valid[0]
    return {"bboxes": det.bboxes[0][valid], "scores": det.scores[0][valid],
            "labels": det.labels[0][valid],
            "landmarks": det.landmarks[0][valid]}


def _dispatch(bundle: DetectorBundle, img: Image) -> Detections:
    img = _read(img)
    H, W = img.shape[:2]
    scale = _test_scale(bundle.cfg)
    nh, nw, sf, [(_, norm)] = _augment(img, scale, False)
    canvas = bucket_canvas(scale, H, W)
    return bundle.fwd_for(canvas)(*_on_card(
        bundle, pad_to_shape(norm, canvas), nh, nw, sf))


def inference_detector(bundle: DetectorBundle,
                       img: Image) -> Dict[str, np.ndarray]:
    """Run one image through the test pipeline + model + decode."""
    return _result(_dispatch(bundle, img))


def aug_test_simple(bundle: DetectorBundle, img: Image,
                    scales: Optional[list] = None, flip: bool = True
                    ) -> Dict[str, np.ndarray]:
    """Simple TTA (reference ``aug_test_simple``, bbox task): the
    candidates of every augmentation WITHOUT NMS, mapped back,
    concatenated, then ONE class-wise NMS."""
    from .evalkit.tta import bbox_flip, extreme_flip

    kind = type(bundle.model.head).__name__
    if kind not in ("LSHead", "LSCPVHead"):
        raise NotImplementedError(
            f"aug_test_simple takes LSNet's candidates, which a {kind} "
            "does not give; use aug_test")
    img = _read(img)
    scales = scales or [(1333, 800)]
    H, W = img.shape[:2]
    cfg = test_cfg_from(bundle.cfg, bundle.canvas)  # NMS params only
    all_b, all_l, all_s = [], [], []
    for scale in scales:
        nh, nw, sf, augs = _augment(img, scale, flip)
        canvas = bucket_canvas(scale, H, W)
        tcfg = test_cfg_from(bundle.cfg, canvas)
        for do_flip, norm in augs:
            images, shapes, _ = _on_card(bundle, pad_to_shape(norm, canvas),
                                         nh, nw, sf)
            with torch.inference_mode():
                outs = bundle.model(images, bundle.sampling)
                b, l, s = lsnet_decode_candidates(
                    outs, shapes, torch.ones(1, 4, device=images.device),
                    tcfg, rescale=False)
            b = b[0].double().cpu().numpy()
            l = l[0].double().cpu().numpy()
            s = s[0].cpu().numpy()
            if do_flip:
                b = bbox_flip(b, (nh, nw))
                l = extreme_flip(l, (nh, nw))
            b /= sf
            l /= np.tile(sf[:2], l.shape[1] // 2)
            all_b.append(b)
            all_l.append(l)
            all_s.append(s)

    def cat(parts):
        return torch.from_numpy(np.concatenate(parts).astype(np.float32)
                                )[None].to(bundle.device)

    with torch.inference_mode():
        det = nms_candidates(cat(all_b), cat(all_l), cat(all_s), cfg)
    return _result(det)


def aug_test(bundle: DetectorBundle, img: Image,
             scales: Optional[list] = None, flip: bool = True,
             scale_ranges: Optional[list] = None) -> Dict[str, np.ndarray]:
    """Multi-scale + flip TTA with soft voting (reference
    ``aug_test_vote``): each (scale, flip) augmentation runs forward +
    decode; the per-augmentation detections merge by IoU-weighted voting
    (:func:`lsnet_torch.evalkit.tta.aug_test_vote`, its vote on the
    bundle's device)."""
    from .evalkit.tta import aug_test_vote

    img = _read(img)
    scales = scales or [(1333, 800)]
    # reference default vote scale ranges (one per scale)
    if scale_ranges is None:
        scale_ranges = [(0, 10000)] * len(scales)
    task = bundle.cfg.model.bbox_head.get("task", "bbox")
    H, W = img.shape[:2]
    aug_results, metas = [], []
    for scale in scales:
        nh, nw, sf, augs = _augment(img, scale, flip)
        canvas = bucket_canvas(tuple(scale), H, W)
        for do_flip, norm in augs:
            r = _result(bundle.fwd_for(canvas)(*_on_card(
                bundle, pad_to_shape(norm, canvas), nh, nw,
                np.ones(4, np.float32))))
            aug_results.append(dict(bboxes=r["bboxes"], scores=r["scores"],
                                    labels=r["labels"],
                                    vectors=r["landmarks"]))
            metas.append(dict(img_shape=(nh, nw), scale_factor=sf,
                              flip=do_flip))
    return aug_test_vote(aug_results, metas, scale_ranges, task=task,
                         num_classes=bundle.cfg.model.bbox_head.num_classes,
                         device=bundle.device)


def show_result(img: np.ndarray, result: Dict[str, np.ndarray], task: str,
                score_thr: float = 0.3,
                out_file: Optional[str] = None) -> np.ndarray:
    from .utils.visualize import (imshow_extremes, imshow_polygons,
                                  imshow_pose)
    if task == "bbox":
        return imshow_extremes(img, result["bboxes"], result["landmarks"],
                               result["labels"], result["scores"],
                               score_thr, out_file=out_file)
    if task == "segm":
        return imshow_polygons(img, result["bboxes"], result["landmarks"],
                               result["labels"], result["scores"],
                               score_thr, out_file=out_file)
    return imshow_pose(img, result["bboxes"], result["landmarks"],
                       result["scores"], score_thr, out_file=out_file)


async def async_inference_detector(bundle: DetectorBundle,
                                   img: Image) -> Dict[str, np.ndarray]:
    """Asynchronous single-image inference (reference
    ``mmdet/apis/inference.py`` + ``utils/contextmanagers.py``): the
    image's work is queued on the card, then awaited on a CUDA event off
    the event loop, so many inferences can be in flight."""
    from .utils.contextmanagers import await_ready

    det = await await_ready(_dispatch(bundle, img))
    return _result(det)
