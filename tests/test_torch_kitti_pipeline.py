"""The port's host data pipeline (``de6d_tpu_torch.datasets``, its numpy
helpers under ``de6d_tpu_torch.utils``) against the JAX package's.

The port keeps its own copies of these numpy modules, so everything is
held bit for bit (``np.array_equal`` with equal dtypes), no tolerance:
the loader's batches on ``data/kitti`` with ``pointpillar.yaml``'s
``DATA_CONFIG`` (every batch of train epoch 0 at batch 4, the val split,
a second epoch, 1 and 4 workers, a loader started while another
thread holds a lock), each augmentor op on the same
``RandomState``, and the processors, calibration, label parsing, box and
rotated-IoU helpers on seeded inputs. ``kitti_loader_jax_ref.npz`` holds
the JAX loader's first 8 train batches of epoch 0 and its first val
batch (at the eval's batch 8) for the card's check without JAX
(``chip_smoke.check_loader``); regenerate it with :func:`write_fixture`.
"""

import copy
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

CFG = ROOT / "configs/kitti_models/pointpillar.yaml"
FIXTURE = ROOT / "de6d_tpu_torch/testdata/kitti_loader_jax_ref.npz"
KITTI = ROOT / "data/kitti"


def _cfgs():
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg
    from de6d_tpu_torch.config import cfg_from_yaml_file

    import os
    cwd = os.getcwd()
    os.chdir(ROOT)  # _BASE_CONFIG_ resolves from the repository root
    try:
        return jax_cfg(str(CFG)), cfg_from_yaml_file(str(CFG))
    finally:
        os.chdir(cwd)


def _loaders(training, batch_size, workers=4, seed=0):
    """(JAX loader, port loader). The JAX one has one worker: with more,
    its samples race for the database sampler's shared ring pointer and
    two runs give different batches (the port's loader hands the sampler
    to samples in order, so its batches equal these with any number of
    workers)."""
    from de6d_tpu.datasets import build_dataloader as jax_build
    from de6d_tpu_torch.datasets import build_dataloader

    jcfg, tcfg = _cfgs()
    _, jl = jax_build(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size,
                      root_path=str(KITTI), training=training, seed=seed,
                      workers=1)
    _, tl = build_dataloader(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, batch_size,
                             root_path=str(KITTI), training=training,
                             seed=seed, workers=workers)
    return jl, tl


def _calib_state(c):
    return {k: v for k, v in vars(c).items()}


def assert_batches_equal(got, want, where=""):
    """Every key, bit for bit (arrays: same dtype, shape and bytes; calib
    objects: every attribute)."""
    assert sorted(got) == sorted(want), (where, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, (where, k)
            assert np.array_equal(g, w), (where, k)
        elif k == "calib":
            for gc, wc in zip(g, w, strict=True):
                gs, ws = _calib_state(gc), _calib_state(wc)
                assert sorted(gs) == sorted(ws), (where, k)
                for a in ws:
                    assert np.array_equal(np.asarray(gs[a]),
                                          np.asarray(ws[a])), (where, k, a)
        else:
            assert g == w, (where, k, g, w)


def _epoch(loader, epoch, n=None):
    loader.set_epoch(epoch)
    out = []
    for b in loader:
        out.append(b)
        if n is not None and len(out) == n:
            break
    return out


@pytest.fixture(scope="module")
def train_epochs():
    """Both loaders' train epoch 0 (every batch) and epoch 1's first 3
    batches, at batch 4: (JAX's, the port's)."""
    jl, tl = _loaders(True, 4)
    want = _epoch(jl, 0), _epoch(jl, 1, 3)
    got = _epoch(tl, 0), _epoch(tl, 1, 3)
    tl.close()
    return want, got


def test_train_epoch0_equals_jax_loader(train_epochs):
    """All 75 batches of train epoch 0 at batch 4 (gt sampling, flip,
    rotation, scaling, shuffle, padding), key for key and bit for bit."""
    (want, _), (got, _) = train_epochs
    assert len(got) == len(want) == 75
    for i, (g, w) in enumerate(zip(got, want)):
        assert_batches_equal(g, w, f"train batch {i}")


def test_val_split_equals_jax_loader():
    """The whole val split at batch 8 (no augmentation, no drop_last: the
    last batch holds 4 frames)."""
    jl, tl = _loaders(False, 8)
    want = _epoch(jl, 0)
    got = _epoch(tl, 0)
    tl.close()
    assert [b["batch_size"] for b in got] == [8] * 12 + [4]
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert_batches_equal(g, w, f"val batch {i}")


def test_second_epoch_and_workers(train_epochs):
    """Epoch 1's first batches (another shuffle and other augmentation
    seeds, the sampler's ring where epoch 0 left it) equal JAX's; 1
    worker gives epoch 0's batches as 4 do."""
    (want0, want1), (_, got1) = train_epochs
    for i, (g, w) in enumerate(zip(got1, want1, strict=True)):
        assert_batches_equal(g, w, f"epoch 1 batch {i}")
    assert not np.array_equal(got1[0]["points"], want0[0]["points"])
    _, one = _loaders(True, 4, workers=1)
    for i, (g, w) in enumerate(zip(_epoch(one, 0, 3), want0[:3])):
        assert_batches_equal(g, w, f"1 worker, batch {i}")
    one.close()


_HELD = threading.Lock()


class _Gated:
    """The port's dataset, each of whose samples takes ``_HELD`` first:
    a lock that a thread of the consumer's process holds while the
    loader's process starts (as CUDA's and PyTorch's threads may hold
    theirs). A child forked then would inherit it held and never give a
    batch; a spawned one starts with its own."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def getitem_prepared(self, *args, **kwargs):
        with _HELD:
            pass
        return self.dataset.getitem_prepared(*args, **kwargs)

    def collate_batch(self, batch_list):
        return self.dataset.collate_batch(batch_list)


def test_loader_starts_while_another_thread_holds_a_lock(train_epochs):
    """The loader's process starts while another thread holds a lock its
    samples need, and gives epoch 0's first batch (JAX's) all the same."""
    from de6d_tpu_torch.datasets import build_dataloader
    from de6d_tpu_torch.datasets.loader import DataLoader

    (want0, _), _ = train_epochs
    _, tcfg = _cfgs()
    ds, _ = build_dataloader(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, 4,
                             root_path=str(KITTI), training=True)
    loader = DataLoader(_Gated(ds), batch_size=4, shuffle=True, seed=0,
                        num_workers=2)
    held, release = threading.Event(), threading.Event()

    def hold():
        with _HELD:
            held.set()
            release.wait(timeout=120)

    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    held.wait()
    got = []
    consumer = threading.Thread(target=lambda: got.append(next(iter(loader))),
                                daemon=True)
    consumer.start()
    consumer.join(timeout=90)
    release.set()
    loader.close()
    assert got, "no batch: the loader's process inherited the held lock"
    assert_batches_equal(got[0], want0[0], "first batch")


# ---------------------------------------------------------------------
# augmentor ops
# ---------------------------------------------------------------------

def _scene(seed, n_boxes=6, n_points=3000, nine=False):
    """Points around seeded boxes and the boxes' names."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((n_boxes, 7), np.float32)
    boxes[:, 0] = rng.uniform(5, 60, n_boxes)
    boxes[:, 1] = rng.uniform(-30, 30, n_boxes)
    boxes[:, 2] = rng.uniform(-1.5, -0.5, n_boxes)
    boxes[:, 3:6] = rng.uniform(0.5, 4.0, (n_boxes, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
    if nine:
        boxes = np.concatenate(
            [boxes, rng.uniform(-0.2, 0.2, (n_boxes, 2))], axis=1)
    pts = np.zeros((n_points, 4), np.float32)
    pts[:, 0] = rng.uniform(0, 70, n_points)
    pts[:, 1] = rng.uniform(-40, 40, n_points)
    pts[:, 2] = rng.uniform(-3, 1, n_points)
    pts[:, 3] = rng.uniform(0, 1, n_points)
    near = rng.randint(0, n_boxes, n_points // 2)
    pts[: n_points // 2, :3] = (boxes[near, :3]
                                + rng.normal(0, 0.5, (n_points // 2, 3)))
    names = np.array(["Car", "Pedestrian", "Cyclist"])[
        np.arange(n_boxes) % 3]
    return {"points": pts, "gt_boxes": boxes, "gt_names": names}


PYRAMID = {"Car": {"PROB": 0.5, "MAX_NUM": 50},
           "Pedestrian": {"PROB": 0.7, "MAX_NUM": 20}}
AUG_CASES = [
    {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
    {"NAME": "random_world_rotation",
     "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
    {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
    {"NAME": "random_world_translation",
     "NOISE_TRANSLATE_STD": [0.5, 0.5, 0.2]},
    {"NAME": "random_local_rotation",
     "LOCAL_ROT_ANGLE": [-0.15707963, 0.15707963]},
    {"NAME": "random_local_scaling", "LOCAL_SCALE_RANGE": [0.95, 1.05]},
    {"NAME": "random_local_translation",
     "LOCAL_TRANSLATION_RANGE": [0, 0.25], "ALONG_AXIS_LIST": ["x", "y", "z"]},
    {"NAME": "random_world_frustum_dropout",
     "INTENSITY_RANGE": [0, 0.2], "DIRECTION": ["top", "bottom", "left",
                                                "right"]},
    {"NAME": "random_local_pyramid_dropout",
     "Car": {"PROB": 0.5}, "Pedestrian": {"PROB": 0.7}},
    {"NAME": "random_local_pyramid_sparsify", **PYRAMID},
    {"NAME": "random_local_pyramid_swap", **PYRAMID},
    {"NAME": "random_local_pyramid_aug",
     "DROPOUT": {"all": {"PROB": 0.3}},
     "SPARSIFY": {"all": {"PROB": 0.5, "MAX_NUM": 40}},
     "SWAP": {"all": {"PROB": 0.5, "MAX_NUM": 40}}},
    {"NAME": "random_make_slope_in_scene", "PROB": 1.0},
    {"NAME": "random_make_slope_in_scene", "PROB": 1.0, "SMOOTH": True},
]


@pytest.mark.parametrize("case", AUG_CASES,
                         ids=[f"{c['NAME']}{'_smooth' if c.get('SMOOTH') else ''}"
                              for c in AUG_CASES])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentor_op_equals_jax(case, seed):
    """One op through each package's ``DataAugmentor`` on the same scene
    and the same ``RandomState``: every output array bit-equal, and both
    generators left in the same state."""
    from de6d_tpu.datasets.augmentor.data_augmentor import (
        DataAugmentor as JaxAug,
    )
    from de6d_tpu_torch.datasets.augmentor.data_augmentor import (
        DataAugmentor,
    )

    cfg = {"AUG_CONFIG_LIST": [case]}
    scene = _scene(seed)
    j = JaxAug(KITTI, copy.deepcopy(cfg), ["Car", "Pedestrian", "Cyclist"])
    t = DataAugmentor(KITTI, copy.deepcopy(cfg),
                      ["Car", "Pedestrian", "Cyclist"])
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
    want = j.forward(copy.deepcopy(scene), jr)
    got = t.forward(copy.deepcopy(scene), tr)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert jr.randint(1 << 30) == tr.randint(1 << 30)


def test_image_flip_equals_jax():
    """``random_image_flip`` (camera models): image, depth map, boxes and
    2D boxes, with each package's own ``Calibration`` of one frame."""
    from de6d_tpu.datasets.augmentor.data_augmentor import (
        DataAugmentor as JaxAug,
    )
    from de6d_tpu.utils.calibration_kitti import Calibration as JaxCalib
    from de6d_tpu_torch.datasets.augmentor.data_augmentor import (
        DataAugmentor,
    )
    from de6d_tpu_torch.utils.calibration_kitti import Calibration

    cfg = {"AUG_CONFIG_LIST": [{"NAME": "random_image_flip",
                                "ALONG_AXIS_LIST": ["horizontal"]}]}
    calib_file = KITTI / "training/calib/000000.txt"
    flipped = 0
    for seed in range(6):
        rng = np.random.RandomState(seed)
        scene = _scene(seed)
        scene["images"] = rng.uniform(0, 1, (12, 20, 3)).astype(np.float32)
        scene["depth_maps"] = rng.uniform(0, 80, (12, 20)).astype(np.float32)
        scene["gt_boxes2d"] = rng.uniform(0, 20, (6, 4)).astype(np.float32)
        want = JaxAug(KITTI, cfg, ["Car"]).forward(
            {**copy.deepcopy(scene), "calib": JaxCalib(calib_file)},
            np.random.RandomState(seed))
        got = DataAugmentor(KITTI, cfg, ["Car"]).forward(
            {**copy.deepcopy(scene), "calib": Calibration(calib_file)},
            np.random.RandomState(seed))
        for k in ("images", "depth_maps", "gt_boxes", "gt_boxes2d",
                  "points"):
            assert np.array_equal(got[k], want[k]), (seed, k)
        flipped += not np.array_equal(got["images"], scene["images"])
    assert 0 < flipped < 6


def test_gt_sampling_equals_jax():
    """The database sampler alone on frames of ``data/kitti``: sampled
    objects, points and boxes bit-equal."""
    jcfg, tcfg = _cfgs()
    from de6d_tpu.datasets.augmentor.data_augmentor import (
        DataAugmentor as JaxAug,
    )
    from de6d_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
    from de6d_tpu_torch.datasets.augmentor.data_augmentor import (
        DataAugmentor,
    )

    aug = [c for c in jcfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST
           if c["NAME"] == "gt_sampling"]
    cfg = {"AUG_CONFIG_LIST": copy.deepcopy(aug)}
    names = list(jcfg.CLASS_NAMES)
    j = JaxAug(KITTI, copy.deepcopy(cfg), names)
    t = DataAugmentor(KITTI, copy.deepcopy(cfg), names)
    ds = JaxKitti(dataset_cfg=jcfg.DATA_CONFIG, class_names=names,
                  root_path=KITTI, training=False)
    for i in range(4):
        info = ds.kitti_infos[i]
        annos = info["annos"]
        keep = annos["name"] != "DontCare"
        scene = {"points": ds.get_lidar(info["point_cloud"]["lidar_idx"]),
                 "gt_boxes": annos["gt_boxes_lidar"],
                 "gt_names": annos["name"][keep]}
        want = j.forward(copy.deepcopy(scene), np.random.RandomState(i))
        got = t.forward(copy.deepcopy(scene), np.random.RandomState(i))
        assert want["gt_boxes"].shape[0] > scene["gt_boxes"].shape[0]
        for k in want:
            assert np.array_equal(got[k], want[k]), (i, k)


def test_augmentor_pickles_with_its_state():
    """The augmentor goes to the loader's process by pickle: its ops are
    rebuilt from their configs and the database sampler keeps where its
    ring stands, so the copy's next sample equals the original's."""
    import pickle

    from de6d_tpu_torch.datasets.augmentor.data_augmentor import (
        DataAugmentor,
    )

    _, tcfg = _cfgs()
    names = list(tcfg.CLASS_NAMES)
    cfg = copy.deepcopy(tcfg.DATA_CONFIG.DATA_AUGMENTOR)
    aug = DataAugmentor(KITTI, cfg, names)
    assert len(aug.data_augmentor_queue) == 4
    scenes = [_scene(s) for s in (0, 1)]
    aug.forward(copy.deepcopy(scenes[0]), np.random.RandomState(0))
    twin = pickle.loads(pickle.dumps(aug))
    want = aug.forward(copy.deepcopy(scenes[1]), np.random.RandomState(1))
    got = twin.forward(copy.deepcopy(scenes[1]), np.random.RandomState(1))
    assert want["gt_boxes"].shape[0] > scenes[1]["gt_boxes"].shape[0]
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_shared_gt_database_is_one_segment_per_file(tmp_path):
    """``USE_SHARED_MEMORY``: two databases at other paths publish two
    segments (never one under a shared name), each holding its own file;
    a pickled sampler attaches to its original's segment."""
    import pickle

    from de6d_tpu_torch.datasets.augmentor.database_sampler import (
        DataBaseSampler, _unlink_quietly,
    )

    cfg = {"NAME": "gt_sampling", "DB_INFO_PATH": ["absent.pkl"],
           "DB_DATA_PATH": ["kitti_gt_database_train_global.npy"],
           "USE_SHARED_MEMORY": True, "PREPARE": {},
           "SAMPLE_GROUPS": ["Car:3"], "NUM_POINT_FEATURES": 4}
    samplers = []
    try:
        for i in range(2):
            root = tmp_path / f"tree{i}"
            root.mkdir()
            np.save(root / cfg["DB_DATA_PATH"][0],
                    np.full((5 + i, 4), i, np.float32))
            samplers.append(DataBaseSampler(root, cfg, ["Car"]))
        a, b = samplers
        assert a._shm.name != b._shm.name
        assert a.gt_database_data.shape == (5, 4)
        assert (a.gt_database_data == 0).all()
        assert b.gt_database_data.shape == (6, 4)
        assert (b.gt_database_data == 1).all()
        twin = pickle.loads(pickle.dumps(a))
        samplers.append(twin)
        assert twin._shm.name == a._shm.name
        assert np.array_equal(twin.gt_database_data, a.gt_database_data)
    finally:
        for s in samplers:
            _unlink_quietly(s._shm)


# ---------------------------------------------------------------------
# processors, calibration, labels, box helpers, rotated IoU
# ---------------------------------------------------------------------

@pytest.mark.parametrize("training", [True, False])
def test_encoder_and_processor_equal_jax(training):
    """``PointFeatureEncoder`` then ``DataProcessor`` (range mask, box
    mask, shuffle, pad) with the yaml's configs."""
    from de6d_tpu.datasets.processor.data_processor import (
        DataProcessor as JaxProc,
    )
    from de6d_tpu.datasets.processor.point_feature_encoder import (
        PointFeatureEncoder as JaxEnc,
    )
    from de6d_tpu_torch.datasets.processor.data_processor import (
        DataProcessor,
    )
    from de6d_tpu_torch.datasets.processor.point_feature_encoder import (
        PointFeatureEncoder,
    )

    jcfg, _ = _cfgs()
    dc = jcfg.DATA_CONFIG
    pc = np.array(dc.POINT_CLOUD_RANGE, np.float32)
    for seed in range(3):
        scene = _scene(seed, n_points=20000)
        scene["gt_boxes"] = np.concatenate(
            [scene["gt_boxes"], np.ones((6, 1), np.float32)], axis=1)
        scene.pop("gt_names")
        outs = []
        for enc_cls, proc_cls in ((JaxEnc, JaxProc),
                                  (PointFeatureEncoder, DataProcessor)):
            enc = enc_cls(dc.POINT_FEATURE_ENCODING)
            proc = proc_cls(dc.DATA_PROCESSOR, point_cloud_range=pc,
                            training=training,
                            num_point_features=enc.num_point_features)
            d = copy.deepcopy(scene)
            d["_rng"] = np.random.RandomState(seed)
            d = proc.forward(enc.forward(d))
            d.pop("_rng")
            outs.append((d, proc.grid_size, proc.voxel_size))
        (want, wg, wv), (got, gg, gv) = outs
        assert np.array_equal(gg, wg) and np.array_equal(gv, wv)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (seed, k)


def test_calibration_and_labels_equal_jax():
    """Every transform of ``Calibration`` on seeded points, and the parsed
    label objects, for the first val frames."""
    from de6d_tpu.utils import calibration_kitti as jcal
    from de6d_tpu.utils import object3d_kitti as jobj
    from de6d_tpu_torch.utils import calibration_kitti as tcal
    from de6d_tpu_torch.utils import object3d_kitti as tobj

    rng = np.random.RandomState(0)
    pts = rng.uniform(-40, 70, (500, 3)).astype(np.float32)
    for idx in ("000300", "000301", "000302"):
        cf = KITTI / f"training/calib/{idx}.txt"
        j, t = jcal.Calibration(cf), tcal.Calibration(cf)
        rect = j.lidar_to_rect(pts)
        for name, args in (("lidar_to_rect", (pts,)),
                           ("rect_to_lidar", (rect,)),
                           ("rect_to_img", (rect,)),
                           ("lidar_to_img", (pts,)),
                           ("img_to_rect", (pts[:, 0], pts[:, 1],
                                            pts[:, 2] + 50))):
            w, g = getattr(j, name)(*args), getattr(t, name)(*args)
            w, g = (x if isinstance(x, tuple) else (x,) for x in (w, g))
            for a, b in zip(g, w, strict=True):
                assert np.array_equal(a, b), (idx, name)
        lf = KITTI / f"training/label_2/{idx}.txt"
        for jo, to in zip(jobj.get_objects_from_label(lf),
                          tobj.get_objects_from_label(lf), strict=True):
            ja, ta = vars(jo), vars(to)
            assert sorted(ja) == sorted(ta)
            for k in ja:
                assert np.array_equal(np.asarray(ta[k]), np.asarray(ja[k])), k


def _boxes(rng, n, nine=False):
    b = np.zeros((n, 9 if nine else 7), np.float32)
    b[:, 0:2] = rng.uniform(-20, 20, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.3, 5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    if nine:
        b[:, 7:9] = rng.uniform(-0.3, 0.3, (n, 2))
    return b


def test_box_helpers_equal_jax():
    """``box_np_ops`` and ``box_np_utils`` on seeded boxes, points and a
    frame's calibration."""
    from de6d_tpu.utils import box_np_ops as jops
    from de6d_tpu.utils import box_np_utils as jutl
    from de6d_tpu.utils.calibration_kitti import Calibration as JaxCalib
    from de6d_tpu_torch.utils import box_np_ops as tops
    from de6d_tpu_torch.utils import box_np_utils as tutl
    from de6d_tpu_torch.utils.calibration_kitti import Calibration

    rng = np.random.RandomState(3)
    b7, b9 = _boxes(rng, 40), _boxes(rng, 40, nine=True)
    b7[:, 0] = np.abs(b7[:, 0]) + 5
    pts = rng.uniform(-25, 25, (2000, 3)).astype(np.float32)
    cf = KITTI / "training/calib/000300.txt"
    jc, tc = JaxCalib(cf), Calibration(cf)
    limit = np.array([0, -20, -3, 20, 20, 1], np.float32)
    cam = jops.boxes3d_lidar_to_kitti_camera(b7, jc)
    pairs = [
        (jops.boxes_to_corners_3d(b7), tops.boxes_to_corners_3d(b7)),
        (jops.boxes9d_to_corners_3d(b9), tops.boxes9d_to_corners_3d(b9)),
        (cam, tops.boxes3d_lidar_to_kitti_camera(b7, tc)),
        (jops.boxes3d_kitti_camera_to_lidar(cam, jc),
         tops.boxes3d_kitti_camera_to_lidar(cam, tc)),
        (jops.boxes3d_to_corners3d_kitti_camera(cam),
         tops.boxes3d_to_corners3d_kitti_camera(cam)),
        (jops.boxes3d_kitti_camera_to_imageboxes(cam, jc, (375, 1242)),
         tops.boxes3d_kitti_camera_to_imageboxes(cam, tc, (375, 1242))),
        (jops.in_hull_obb(pts, b9[0]), tops.in_hull_obb(pts, b9[0])),
        (jops.mask_boxes_outside_range_numpy(b7, limit),
         tops.mask_boxes_outside_range_numpy(b7, limit)),
        (jutl.boxes_to_rotation_matrix(b9), tutl.boxes_to_rotation_matrix(b9)),
        (jutl.boxes_to_corners_3d(b9), tutl.boxes_to_corners_3d(b9)),
        (jutl.points_in_boxes_mask(pts, b9), tutl.points_in_boxes_mask(pts, b9)),
        (jutl.points_in_boxes_index(pts, b7), tutl.points_in_boxes_index(pts, b7)),
        (jutl.mask_boxes_outside_range(b7, limit),
         tutl.mask_boxes_outside_range(b7, limit)),
    ]
    for i, (w, g) in enumerate(pairs):
        assert np.asarray(g).dtype == np.asarray(w).dtype, i
        assert np.array_equal(g, w), i
    assert pairs[10][0].any()


def test_rotate_iou_np_equals_jax():
    """The eval's rotated IoU (criterion -1, 0, 1), the sampler's BEV IoU
    and the host 3D IoU on seeded, overlapping and identical boxes."""
    from de6d_tpu.datasets.eval import rotate_iou_np as j
    from de6d_tpu_torch.datasets.eval import rotate_iou_np as t

    rng = np.random.RandomState(5)
    a = _boxes(rng, 30)
    b = np.concatenate([a[:10] + rng.normal(0, 0.3, (10, 7)).astype(
        np.float32), a[10:15], _boxes(rng, 15)])
    bev_a, bev_b = a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]]
    for crit in (-1, 0, 1):
        w = j.rotate_iou_matrix(bev_a, bev_b, criterion=crit)
        assert np.array_equal(t.rotate_iou_matrix(bev_a, bev_b,
                                                  criterion=crit), w)
    assert np.array_equal(t.boxes_bev_iou_cpu(a, b), j.boxes_bev_iou_cpu(a, b))
    w = j.boxes_iou3d_cpu(a, b)
    assert np.array_equal(t.boxes_iou3d_cpu(a, b), w)
    assert (w > 0.3).sum() >= 10


# ---------------------------------------------------------------------
# the stored fixture
# ---------------------------------------------------------------------

def loader_reference(loader_batches, val_batch):
    """The fixture's arrays: for each train batch and the val batch its
    arrays, with ``points`` as a sha256 digest of its bytes for train
    batches after the first (the valid rows of the first train batch and
    of the val batch stored in full), and the calibration matrices."""
    import hashlib

    out = {}
    for tag, batches in (("train", loader_batches), ("val", [val_batch])):
        out[f"{tag}_batches"] = np.int64(len(batches))
        for i, b in enumerate(batches):
            p = f"{tag}{i}_"
            pts = b["points"]
            out[p + "points_sha256"] = np.array(
                hashlib.sha256(np.ascontiguousarray(pts).tobytes()).hexdigest())
            out[p + "points_shape"] = np.array(pts.shape, np.int64)
            if i == 0:
                out[p + "points_valid"] = pts[b["points_mask"]]
            out[p + "points_mask"] = b["points_mask"]
            out[p + "gt_boxes"] = b["gt_boxes"]
            out[p + "image_shape"] = b["image_shape"]
            out[p + "frame_id"] = np.array(b["frame_id"])
            for m in ("P2", "R0", "V2C"):
                out[p + f"calib_{m}"] = np.stack([getattr(c, m)
                                                  for c in b["calib"]])
    return out


def write_fixture(path=FIXTURE):
    """JAX loader on ``data/kitti`` (``pointpillar.yaml``, seed 0, one
    worker): the first 8 train batches of epoch 0 at batch 4 and the
    first val batch at batch 8 (~5 s)."""
    jl, _ = _loaders(True, 4)
    train = _epoch(jl, 0, 8)
    vl, _ = _loaders(False, 8)
    val = _epoch(vl, 0, 1)[0]
    np.savez_compressed(path, **loader_reference(train, val))


def test_port_loader_matches_fixture():
    """The port's loader, alone, against the stored JAX batches (what the
    card's ``pipeline / kitti`` phase checks: ``chip_smoke.check_loader``)."""
    import chip_smoke

    res = chip_smoke.check_loader(workers=2)
    assert res["train_batches"] == 8 and res["val_batches"] == 1


@pytest.mark.slow
def test_fixture_is_fresh():
    """A fresh JAX run reproduces the stored fixture."""
    jl, _ = _loaders(True, 4)
    vl, _ = _loaders(False, 8)
    fresh = loader_reference(_epoch(jl, 0, 8), _epoch(vl, 0, 1)[0])
    with np.load(FIXTURE) as ref:
        assert sorted(ref.files) == sorted(fresh)
        for k in ref.files:
            assert np.array_equal(ref[k], fresh[k]), k
