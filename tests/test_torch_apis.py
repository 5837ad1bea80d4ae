"""The port's image-level API (``lsnet_torch.apis``) and TTA against the JAX
package's, on the CPU.

* JAX's ``tests/test_apis.py::tiny_cfg`` (R18, FPN and a norm-tower bbox
  LSHead at 32 channels, 3 classes, 64x64 canvas) through both packages'
  ``init_detector``; the port's weights from ``random_weights_`` (JAX's
  own init gives no detection at all), carried to JAX by
  ``weights.to_jax_variables`` (JAX's ``init_detector`` then runs with a
  shape-only ``model.init``: its draws would be replaced). On one seeded 48x56 uint8 image (and the
  same image as a PNG path): ``inference_detector``, ``aug_test`` at two
  scales with flip and ``aug_test_simple`` at the same: the same number
  of detections and labels, boxes and landmarks within 1e-3 pixels,
  scores within 1e-4; each result is non-empty.
* ``bucket_canvas``; ``test_cfg.dcn_sampling`` and a checkpoint's deploy
  sampling; ``fuse_conv_bn=True`` (detections within 1e-3 of unfused).
* The flip and mapping functions (bit for bit), ``instances_vote_batch``
  (within 1e-5 of JAX's, the single-detection class included) and
  ``aug_test_vote`` (device route and numpy oracle) against JAX's.
* ``async_inference_detector`` equal to the sync call; ``show_result``
  writing a file for each task.

The JAX package's sampling policy is process-wide: it is pinned with
``monkeypatch`` while the JAX functions trace.
"""

import asyncio

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu import apis as japis
from lsnet_tpu.evalkit import tta as jtta
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.ops.vote import instances_vote_batch as j_vote
from lsnet_torch import apis
from lsnet_torch.evalkit import tta
from lsnet_torch.ops.flat_deform import INFERENCE_SAMPLING, SITES
from lsnet_torch.ops.vote import instances_vote_batch
from lsnet_torch.train.checkpoint import save_checkpoint
from lsnet_torch.train.optim import build_optimizer
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import to_jax_variables
from tests.test_apis import IMG, tiny_cfg

torch.set_num_threads(1)

SCALES = [(IMG, IMG), (96, 80)]


def _image(seed=0, hw=(48, 56)):
    return (np.random.RandomState(seed).rand(*hw, 3) * 255).astype(np.uint8)


def _port_cfg(**test_cfg):
    cfg = Config(tiny_cfg().to_dict())
    cfg.test_cfg.update(test_cfg)
    return cfg


def _port_bundle():
    bundle = apis.init_detector(_port_cfg(), canvas=(IMG, IMG),
                                device="cpu")
    apis.random_weights_(bundle.model, 0)
    return bundle


def _shape_only_init(orig):
    """flax ``Module.init`` giving zeros of the variables' shapes
    (``eval_shape``): JAX's ``init_detector`` draws variables that the
    fixture replaces with the port's at once, and its eager init takes
    most of the fixture's time."""
    def init(self, *a, **k):
        return jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                            jax.eval_shape(lambda: orig(self, *a, **k)))
    return init


@pytest.fixture(scope="module")
def results():
    """The port's bundle and JAX's results on the same weights and image."""
    bundle = _port_bundle()
    img = _image()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init",
                   _shape_only_init(flax.linen.Module.init))
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        mp.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
        mp.setattr(jfd, "INFERENCE_SAMPLING", ["backbone=nearest"])
        jb = japis.init_detector(tiny_cfg(), canvas=(IMG, IMG))
        jb.variables = jax.tree.map(jnp.asarray,
                                    to_jax_variables(bundle.model))
        want = {"inference": japis.inference_detector(jb, img),
                "aug_test": japis.aug_test(jb, img, scales=SCALES,
                                           flip=True),
                "aug_test_simple": japis.aug_test_simple(
                    jb, img, scales=SCALES, flip=True)}
    return bundle, img, want


def _sorted(res, vec):
    order = np.lexsort((res["bboxes"][:, 1], res["bboxes"][:, 0],
                        res["labels"]))
    return {k: np.asarray(res[k])[order]
            for k in ("bboxes", "scores", "labels", vec)}


def _assert_same(got, want, vec="landmarks"):
    assert len(want["scores"]) > 0                   # non-empty
    assert len(got["scores"]) == len(want["scores"])
    got, want = _sorted(got, vec), _sorted(want, vec)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    for key, atol in (("bboxes", 1e-3), (vec, 1e-3), ("scores", 1e-4)):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol)


def test_inference_detector_matches_jax(results, tmp_path):
    bundle, img, want = results
    got = apis.inference_detector(bundle, img)
    _assert_same(got, want["inference"])
    from PIL import Image
    path = str(tmp_path / "img.png")
    Image.fromarray(img).save(path)
    from_path = apis.inference_detector(bundle, path)
    for key in got:
        np.testing.assert_array_equal(from_path[key], got[key])


def test_aug_test_matches_jax(results):
    bundle, img, want = results
    got = apis.aug_test(bundle, img, scales=SCALES, flip=True)
    _assert_same(got, want["aug_test"], vec="vectors")


def test_aug_test_simple_matches_jax(results):
    bundle, img, want = results
    got = apis.aug_test_simple(bundle, img, scales=SCALES, flip=True)
    _assert_same(got, want["aug_test_simple"])


def test_bucket_canvas():
    for scale, h, w in [((1333, 800), 480, 640), ((1333, 800), 640, 480),
                        ((3000, 1800), 500, 700), ((1666, 1000), 480, 640),
                        (SCALES[1], 48, 56)]:
        assert apis.bucket_canvas(scale, h, w) == \
            japis.bucket_canvas(scale, h, w)
    assert apis.bucket_canvas((1333, 800), 480, 640) == (800, 1344)
    assert apis.bucket_canvas((1666, 1000), 480, 640) == (1024, 1696)


def _jax_modes(spec):
    """The site -> mode mapping JAX's ``set_sampling(spec)`` leaves."""
    default, policy = jfd._parse_sampling(spec)
    return {site: policy.get(site, default) for site in SITES}


@pytest.mark.parametrize("spec", [None, "nearest",
                                  "backbone=nearest,refine=nearest"])
def test_init_detector_dcn_sampling_cfg(spec):
    """test_cfg.dcn_sampling as JAX's ``init_detector`` applies it; none:
    the shipped inference default."""
    test = {} if spec is None else {"dcn_sampling": spec}
    bundle = apis.init_detector(_port_cfg(**test), device="cpu")
    want = (dict(INFERENCE_SAMPLING) if spec is None
            else _jax_modes(spec))
    assert dict(bundle.sampling) == want


def test_init_detector_from_checkpoint(tmp_path, results):
    """The checkpoint's weights load strictly; its meta deploys (a
    ``nearest_ste`` run deploys ``nearest``); the config's
    ``dcn_sampling`` wins over it; ``fuse_conv_bn`` keeps the
    detections."""
    src = results[0]
    opt, _ = build_optimizer(src.model.parameters(), 0.01, 10, (8, 11))
    path = save_checkpoint(str(tmp_path), src.model, opt, 3,
                           meta={"dcn_sampling_train": "nearest_ste"})
    bundle = apis.init_detector(_port_cfg(), path, device="cpu")
    for k, v in src.model.state_dict().items():
        assert torch.equal(bundle.model.state_dict()[k], v), k
    assert dict(bundle.sampling) == dict.fromkeys(SITES, "nearest")
    bundle = apis.init_detector(_port_cfg(dcn_sampling="bilinear"), path,
                                device="cpu")
    assert dict(bundle.sampling) == dict.fromkeys(SITES, "bilinear")
    fused = apis.init_detector(_port_cfg(), path, fuse_conv_bn=True,
                               device="cpu")
    img = results[1]
    _assert_same(apis.inference_detector(fused, img),
                 apis.inference_detector(
                     apis.init_detector(_port_cfg(), path, device="cpu"),
                     img))


def test_init_detector_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apis.init_detector(_port_cfg())


@pytest.mark.parametrize("fn", ["bbox_flip", "extreme_flip", "polygon_flip",
                                "kps_flip", "instance_mapping_back",
                                "remove_boxes"])
def test_flip_and_mapping_match_jax(fn):
    rng = np.random.RandomState(3)
    boxes = np.sort(rng.uniform(0, 90, (6, 4)), axis=1)
    shape = (70, 100)
    if fn == "remove_boxes":
        args = [(boxes, 8.0, 40.0)]
    elif fn == "instance_mapping_back":
        sf = np.array([0.5, 0.6, 0.5, 0.6])
        args = [(boxes, rng.uniform(0, 90, (6, n)), shape, sf, flip, task)
                for n, task in ((8, "bbox"), (72, "segm"), (34, "pose_kbox"))
                for flip in (False, True)]
    else:
        n = {"bbox_flip": 4, "extreme_flip": 8, "polygon_flip": 72,
             "kps_flip": 34}[fn]
        args = [(rng.uniform(0, 90, (6, n)), shape),
                (np.zeros((0, n)), shape)]
    for a in args:
        got, want = getattr(tta, fn)(*a), getattr(jtta, fn)(*a)
        for g, w_ in zip(*(([x] if isinstance(x, np.ndarray) else x)
                           for x in (got, want))):
            np.testing.assert_array_equal(g, w_)


def _vote_inputs(seed=7, K=3, N=15):
    """K classes of up to N detections with jittered duplicates; the last
    class holds a single detection."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(10, 80, (K, N, 2))
    boxes = np.concatenate([base, base + rng.uniform(10, 40, (K, N, 2))],
                           -1)
    boxes[:, 1] = boxes[:, 0] + rng.uniform(-2, 2, (K, 4))
    boxes[:, 3] = boxes[:, 2] + rng.uniform(-1, 1, (K, 4))
    vectors = rng.randn(K, N, 8)
    scores = rng.uniform(0.1, 1.0, (K, N))
    valid = np.ones((K, N), bool)
    valid[1, 11:] = False
    valid[2, 1:] = False
    order = np.argsort(-np.where(valid, scores, -1), axis=1, kind="stable")

    def take(a):
        return np.take_along_axis(a, order.reshape(K, N, *[1] * (a.ndim - 2)),
                                  1)
    return [take(a).astype(np.float32) for a in (boxes, vectors, scores)] \
        + [take(valid)]


def test_instances_vote_batch_matches_jax():
    args = _vote_inputs()
    got = [x.numpy() for x in instances_vote_batch(
        *(torch.from_numpy(a) for a in args))]
    want = [np.asarray(x) for x in j_vote(*(jnp.asarray(a) for a in args))]
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3][0].any() and got[3][1].any() and not got[3][2].any()
    for g, w_ in zip(got[:3], want[:3]):
        m = want[3]
        np.testing.assert_allclose(g[m], w_[m], rtol=1e-5, atol=1e-5)
    # and the numpy oracle, class by class
    for k in range(2):
        v = args[3][k]
        rb, rv, rs = tta.instances_vote(*(a[k][v].astype(np.float64)
                                          for a in args[:3]))
        np.testing.assert_allclose(got[2][k][got[3][k]], rs, rtol=1e-5)
        np.testing.assert_allclose(got[0][k][got[3][k]], rb, rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("use_device", [True, False])
def test_aug_test_vote_matches_jax(use_device):
    rng = np.random.RandomState(5)
    aug_results, metas = [], []
    for i in range(4):
        n = 12
        b = np.sort(rng.uniform(0, 60, (n, 4)), axis=1)
        b[:4] = b[0] + rng.uniform(-1, 1, (4, 4))
        aug_results.append(dict(bboxes=b, scores=rng.uniform(0.1, 1, n),
                                labels=rng.randint(0, 3, n),
                                vectors=rng.uniform(0, 60, (n, 8))))
        metas.append(dict(img_shape=(64, 64),
                          scale_factor=np.array([1.0, 1.0, 1.0, 1.0]) *
                          (1 + i // 2), flip=bool(i % 2)))
    kw = dict(task="bbox", num_classes=3, use_device=use_device)
    got = tta.aug_test_vote(aug_results, metas, [(0, 10000), (0, 10000)],
                            device="cpu", **kw)
    want = jtta.aug_test_vote(aug_results, metas, [(0, 10000), (0, 10000)],
                              **kw)
    _assert_same(got, want, vec="vectors")


def test_async_inference_matches_sync(results):
    bundle = results[0]
    imgs = [_image(seed) for seed in range(3)]
    sync = [apis.inference_detector(bundle, im) for im in imgs]

    async def main():
        return await asyncio.gather(
            *[apis.async_inference_detector(bundle, im) for im in imgs])

    for s, a in zip(sync, asyncio.run(main())):
        for key in s:
            np.testing.assert_array_equal(s[key], a[key])


@pytest.mark.parametrize("task,nv", [("bbox", 4), ("segm", 36),
                                     ("pose_bbox", 17)])
def test_show_result_writes_a_file(tmp_path, task, nv):
    img = _image()
    rng = np.random.RandomState(1)
    result = {"bboxes": np.array([[5.0, 6.0, 30.0, 40.0]]),
              "scores": np.array([0.9]), "labels": np.array([1]),
              "landmarks": rng.uniform(5, 40, (1, 2 * nv))}
    out_file = str(tmp_path / f"{task}.png")
    out = apis.show_result(img, result, task, out_file=out_file)
    assert out.shape == img.shape and not np.array_equal(out, img)
    from PIL import Image
    with Image.open(out_file) as im:
        assert im.size == (img.shape[1], img.shape[0])
