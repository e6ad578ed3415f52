"""Spatial parallelism (sp) of the port on the CPU: `SpatialPredictor` over
a mesh of CPU entries (one thread a row shard) against JAX's on the
conftest's 8-device CPU mesh and against the port's unsharded forward, and
the content step, the eval step, the Trainer and the train CLI on
`data,space` grids of gloo ranks started by `facesr_torch.parallel.launch`
against the single-process step and JAX's `row_sharding` /
`grid_sharding` steps.

Sizes: FaceEnhanceNet G=2, B=2, C=16 (every weight perturbed off its init
from numpy, conv_last redrawn non-zero); RRDBNet 2 RRDBs x 16 features
(growth 8), the transfer model 2 + 2 x 16; the launch counts at C=64
(6 x 1 x 64, the transfer head 1 x 64) on 8x8 images; training at HR 32, a
global batch of 4, on [1, 2] (2 ranks) and [2, 2] (4 ranks) grids, one
module-scoped launch each (`sp_ranks`); the child processes import torch
and the port only, never JAX.

Tolerances:
- serving in f32, sharded against JAX's `SpatialPredictor` and against the
  port's unsharded forward: atol 2e-5 (JAX's own test's); the SE means
  and the loss sums add in another order, so bitwise is not expected.
  RRDBNet and the transfer model in f32: the same 2e-5; in bf16, `int8`
  and `int8_full` bitwise (at these widths neither runs the kernel);
- serving in bf16 (the plain trunk both ways), ``int8`` (a dequantized
  copy with the plain trunk both ways) and ``int8_full`` (dynamic and
  calibrated scales) against the unsharded forward: bitwise. The halo
  rows are the neighbours' own values, the dynamic scale is a max (exact),
  and the bf16 SE mean, an f32 sum divided and cast once, rounds to the
  same bf16 on these inputs (measured; a tie there would need a stated
  tolerance);
- the controls, each rejected by its check's own tolerance: a zero-filled
  halo, an SE mean over the shard's rows alone (f32, 2e-5) and a dynamic
  int8 scale from the shard's rows alone (bitwise);
- training against the single process on the global batch (the dp tests'
  limits): the loss within 1e-6 absolute, every gradient and parameter
  within 1e-5 relative L2; the eval metrics rtol 1e-5; ranks against each
  other bitwise; against JAX: losses rtol 1e-5, params after 2 steps
  within 1e-5 relative L2 a tensor (the dp test's 5e-6 absolute cannot
  hold on this batch: the port's own single-process step sits 5.6e-6 from
  JAX's single-device step at one element of `upsample.stages.0.conv`, an
  Adam update of a gradient near eps, and JAX's row step 1.3e-6 from
  JAX's single-device one); the Trainer's final `.fckpt` 1e-5 relative L2 a
  tensor, its history rtol 1e-5. The control, gradients summed over
  `space` (S x the right ones), sits far above 1e-5.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.cli.step_numerics import RecordingAdamW
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.parallel import launch, spatial
from facesr_torch.parallel import mesh as pmesh
from facesr_torch.parallel.serving import SpatialPredictor
from facesr_torch.training import steps

torch.set_num_threads(1)

G, B, C, HR, BATCH = 2, 2, 16, 32, 4
LR = 1e-3
LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1)
VGG_LOSS = dict(l1_weight=1.0, perceptual_weight=0.1, ssim_weight=0.1)
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
ROOT = Path(__file__).resolve().parent.parent
ATOL = 2e-5


# ---------------------------------------------------------------------------
# what the ranks and the parent both build (torch and numpy only)


def _perturbed(model, seed=0):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 0.05 if name.startswith("conv_last") else 0.02
            noise = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            p.copy_(noise * scale if name == "conv_last.weight" else p + noise * scale)
    return model


def _model(**kw) -> FaceEnhanceNet:
    cfg = dict(num_channels=C, num_groups=G, blocks_per_group=B, **kw)
    return _perturbed(FaceEnhanceNet(FaceEnhanceNetConfig(**cfg), seed=0, device="cpu"))


def _hr(seed, n=BATCH, size=HR) -> np.ndarray:
    """Smooth HR images in [0, 1]."""
    rng = np.random.default_rng(seed)
    lo = rng.random((n, size // 4, size // 4, 3), dtype=np.float32)
    return np.clip(np.kron(lo, np.ones((1, 4, 4, 1), np.float32))
                   + rng.normal(0, 0.02, (n, size, size, 3)), 0, 1).astype(np.float32)


def _content_step(mesh=None, loss_cfg=LOSS):
    model = _model()
    loss = CombinedLoss(LossConfig(**loss_cfg), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=0.5)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), LR),
                             loss_params=loss.params)
    apply = lambda lp, p, t: loss.apply(lp, p, t)
    return state, opt, steps.make_train_step(apply, opt, mesh=mesh), apply


def _np(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def _rows(x: np.ndarray, mesh) -> torch.Tensor:
    """This rank's batch rows (whole images) of a global batch."""
    return torch.from_numpy(np.ascontiguousarray(pmesh.shard_batch(x, mesh)))


SEEDS = (10, 11)
TRAIN_BATCHES = [_hr(40 + i) for i in range(2)]
VAL_BATCHES = [_hr(50), _hr(51)]


def _trainer(ckpt_dir, train, val, mesh=None, **cfg):
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    config = TrainerConfig(epochs=1, learning_rate=LR, weight_decay=1e-2, gradient_clip=0.5,
                           use_amp=False, save_every=1, checkpoint_dir=str(ckpt_dir),
                           ema_decay=0.9, step_log_every=0, **cfg)
    return Trainer(_model(), train, val, CombinedLoss(LossConfig(**LOSS), device="cpu"),
                   config, device="cpu", mesh=mesh)


def _sp_worker(mesh, tmp, extras):
    """Everything a rank of one grid runs, in one launch."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank, "coords": (mesh.axis_index("data"), mesh.axis_index("space"))}
    state, opt, step, apply = _content_step(mesh)
    losses, grads = [], []
    for seed in SEEDS:
        _, m = step(state, _rows(_hr(seed), mesh))
        losses.append(float(m["loss"]))
        grads.append({k: v.numpy() for k, v in opt.grads.items()})
    out.update(content_losses=losses, content_grads=grads,
               content_params=_np(state.model.state_dict().items()),
               content_mu=_np(state.opt_state["mu"].items()))
    fresh = _content_step(mesh)[0]
    metrics, sr, _ = steps.make_eval_step(apply, mesh=mesh)(fresh, _rows(_hr(20), mesh))
    out["eval"] = {k: float(v) for k, v in metrics.items()}
    out["eval_rows"] = tuple(sr.shape)
    # the control: gradients summed over `space` (a mean over `data` only)
    state, opt, step, _ = _content_step(mesh)
    reduced = steps._reduced
    steps._reduced = lambda g, m: [t * m.axis_size("space") for t in reduced(g, m)]
    try:
        step(state, _rows(_hr(SEEDS[0]), mesh))
    finally:
        steps._reduced = reduced
    out["wrong_factor_grads"] = {k: v.numpy() for k, v in opt.grads.items()}
    if "perceptual" in extras:
        state, opt, step, _ = _content_step(mesh, VGG_LOSS)
        _, m = step(state, _rows(_hr(SEEDS[0]), mesh))
        out["vgg"] = {"loss": float(m["loss"]),
                      "grads": {k: v.numpy() for k, v in opt.grads.items()}}
    if "trainer" in extras:
        train = [{"hr": pmesh.shard_batch(b, mesh)} for b in TRAIN_BATCHES]
        val = [{"hr": pmesh.shard_batch(b, mesh)} for b in VAL_BATCHES]
        tr = _trainer(Path(tmp) / f"rank{mesh.rank}", train, val, mesh,
                      mesh_axes="data,space", mesh_shape=mesh.shape)
        out["history"] = tr.train()
        out["is_writer"] = tr.is_writer
        out["trainer_params"] = _np(tr.model.state_dict().items())
    return out


@pytest.fixture(scope="module")
def sp_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    out = {}
    for name, (d, s) in GRIDS.items():
        extras = ("perceptual", "trainer") if name == "1x2" else ()
        out[name] = launch.run_ranks(_sp_worker, d * s, args=(str(tmp / name), extras),
                                     devices=["cpu"] * (d * s), timeout=120, run_timeout=300,
                                     axis_names=("data", "space"), shape=(d, s))
    return out, tmp


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# training on data,space


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sp_content_step_matches_the_single_process_step_on_the_global_batch(sp_ranks, grid):
    ranks = sp_ranks[0][grid]
    assert [r["coords"] for r in ranks] == [divmod(i, GRIDS[grid][1]) for i in range(len(ranks))]
    state, opt, step, _ = _content_step()
    for i, seed in enumerate(SEEDS):
        _, m = step(state, torch.from_numpy(_hr(seed)))
        for r in ranks:
            assert abs(r["content_losses"][i] - float(m["loss"])) <= 1e-6
            worst = max(_rel_l2(r["content_grads"][i][k], g.numpy()) for k, g in opt.grads.items())
            assert worst <= 1e-5, (i, worst)
    for r in ranks:
        for k, v in state.model.state_dict().items():
            assert _rel_l2(r["content_params"][k], v.numpy()) <= 1e-5, k


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_gradients_reduced_with_the_wrong_factor_over_space_are_rejected(sp_ranks, grid):
    ranks = sp_ranks[0][grid]
    state, opt, step, _ = _content_step()
    step(state, torch.from_numpy(_hr(SEEDS[0])))
    wrong = max(_rel_l2(ranks[0]["wrong_factor_grads"][k], g.numpy())
                for k, g in opt.grads.items())
    assert wrong > 1e-2  # S x the gradient: far past the 1e-5 the step is held to


@pytest.mark.parametrize("part", ["content_params", "content_mu"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_every_rank_of_the_grid_holds_bitwise_the_same_state(sp_ranks, grid, part):
    ranks = sp_ranks[0][grid]
    for r in ranks[1:]:
        assert set(r[part]) == set(ranks[0][part])
        for k, v in ranks[0][part].items():
            assert np.array_equal(r[part][k], v), k


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sp_eval_step_matches_the_single_process_eval_step(sp_ranks, grid):
    d, s = GRIDS[grid]
    state, _, _, apply = _content_step()
    want, _, _ = steps.make_eval_step(apply)(state, torch.from_numpy(_hr(20)))
    for r in sp_ranks[0][grid]:
        assert r["eval_rows"] == (BATCH // d, HR // s, HR, 3)  # the rank's image rows
        for k, v in want.items():
            np.testing.assert_allclose(r["eval"][k], float(v), rtol=1e-5, err_msg=k)


def test_sp_step_with_the_vgg_perceptual_loss_matches_the_single_process_step(sp_ranks):
    ranks = sp_ranks[0]["1x2"]
    state, opt, step, _ = _content_step(loss_cfg=VGG_LOSS)
    _, m = step(state, torch.from_numpy(_hr(SEEDS[0])))
    for r in ranks:
        assert abs(r["vgg"]["loss"] - float(m["loss"])) <= 1e-6
        assert max(_rel_l2(r["vgg"]["grads"][k], g.numpy()) for k, g in opt.grads.items()) <= 1e-5


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sp_content_steps_match_jax_row_and_grid_sharding(sp_ranks, grid):
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.models import face_enhance_net as fen
    from facesr.parallel import get_mesh, grid_sharding, replicate, replicated, row_sharding
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt.weights import jax_params_from, state_dict_from_jax_params

    d, s = GRIDS[grid]
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**LOSS), seed=0)
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=0.5)
    if d == 1:
        mesh = get_mesh(jax.devices()[:s])
        sharding = row_sharding(mesh)
    else:
        mesh = get_mesh(jax.devices()[:d * s], axis_names=("data", "space"), shape=(d, s))
        sharding = grid_sharding(mesh)
    params = jax.tree.map(jnp.asarray, jax_params_from(_model()))
    state = replicate(jsteps.TrainState(step=jnp.asarray(0), params=params,
                                        opt_state=jsteps.set_learning_rate(tx.init(params), LR),
                                        loss_params=jloss.params), mesh)
    step = jax.jit(jsteps.make_train_step(
        lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
        jloss.apply, tx, scale_factor=4, compute_dtype=None),
        in_shardings=(replicated(mesh), sharding))
    ranks = sp_ranks[0][grid]
    for i, seed in enumerate(SEEDS):
        state, m = step(state, jax.device_put(_hr(seed), sharding))
        for r in ranks:
            np.testing.assert_allclose(r["content_losses"][i], float(m["loss"]), rtol=1e-5)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax.device_get(state.params)))
    for r in ranks:
        for k, v in want.items():
            assert _rel_l2(r["content_params"][k], v.numpy()) <= 1e-5, k


def test_a_data_space_trainer_epoch_writes_on_rank0_only_and_equals_the_single_process_one(
        sp_ranks, tmp_path):
    from facesr_torch.ckpt import fckpt

    ranks, tmp = sp_ranks[0]["1x2"], sp_ranks[1] / "1x2"
    assert [r["is_writer"] for r in ranks] == [True, False]
    assert not (tmp / "rank1").exists()
    assert "final_model.fckpt" in {p.name for p in (tmp / "rank0").iterdir()}
    single = _trainer(tmp_path, [{"hr": b} for b in TRAIN_BATCHES],
                      [{"hr": b} for b in VAL_BATCHES])
    history = single.train()
    for k in ("train_loss", "val_loss", "val_psnr", "val_ssim"):
        for r in ranks:
            np.testing.assert_allclose(r["history"][k], history[k], rtol=1e-5, err_msg=k)
    for k, v in single.model.state_dict().items():
        for r in ranks:
            assert _rel_l2(r["trainer_params"][k], v.numpy()) <= 1e-5, k
    assert all(np.array_equal(ranks[0]["trainer_params"][k], ranks[1]["trainer_params"][k])
               for k in ranks[0]["trainer_params"])
    tree, meta = fckpt.load_checkpoint(str(tmp / "rank0" / "final_model.fckpt"))
    assert meta["global_step"] == len(TRAIN_BATCHES)


def test_the_train_cli_trains_on_data_space_over_two_ranks(tmp_path):
    """A plain launch with --mesh-axes data,space --mesh-shape 1,2 starts
    the two ranks itself; both load the same rows (the batch divisor is
    the data axis's 1) and split the image rows."""
    from facesr_torch.ckpt import fckpt
    from facesr_torch.data import png
    from facesr_torch.data.cv_compat import resize_cubic

    rng = np.random.default_rng(0)
    for split, n, size in (("train", 4, 40), ("val", 2, 32)):
        (tmp_path / "data" / split / "HR").mkdir(parents=True)
        if split == "val":
            (tmp_path / "data" / split / "LR").mkdir()
        for i in range(n):
            img = resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (size, size))
            png.write_png(tmp_path / "data" / split / "HR" / f"{i:03d}.png", img)
            if split == "val":
                png.write_png(tmp_path / "data" / split / "LR" / f"{i:03d}.png",
                              resize_cubic(img, (8, 8)))
    text = (ROOT / "configs" / "stages" / "stage1_psnr_config.yaml").read_text()
    for old, new in (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 1"),
                     ("blocks_per_group: 10", "blocks_per_group: 2"),
                     ("batch_size: 48", "batch_size: 2"), ("num_workers: 16", "num_workers: 1"),
                     ("hr_patch_size: 256", "hr_patch_size: 32")):
        assert old in text, old
        text = text.replace(old, new)
    (tmp_path / "s1.yaml").write_text(text)
    proc = subprocess.run(
        [sys.executable, "-m", "facesr_torch.cli.train", "--config", str(tmp_path / "s1.yaml"),
         "--data-root", str(tmp_path / "data"), "--device", "cpu", "--epochs", "1",
         "--mesh-axes", "data,space", "--mesh-shape", "1,2", "--print-memory", "--yes"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT)})
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    assert "Starting 2 ranks" in log
    for r in range(2):
        assert f"rank {r} of 2 on cpu, at (0, {r}) of the data,space grid (1, 2)" in log
    assert "Batch size: 2 global, 2 a rank over 1 rank(s) of the data axis" in log
    assert len(re.findall(r"rank \d of 2, device memory", log)) == 2
    _, meta = fckpt.load_checkpoint(str(tmp_path / "checkpoints" / "final_model.fckpt"))
    assert meta["global_step"] == 2  # 4 images, 2 rows a step on both ranks


# ---------------------------------------------------------------------------
# refusals and the mesh's surface


def _grid_mesh(rank=0):
    """A [1, 2] grid mesh whose groups are never called (for checks made
    before any exchange)."""
    return pmesh.Mesh((torch.device("cpu"),), group=object(), rank=rank, world_size=2,
                      axis_names=("data", "space"), shape=(1, 2),
                      axis_groups={"space": object(), "data": object()})


def test_the_mesh_builds_the_grid_and_shards_batch_and_image_rows():
    x = np.arange(4 * 8 * 2, dtype=np.float32).reshape(4, 8, 2, 1)
    for rank in range(4):
        mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), rank=rank, world_size=4,
                          axis_names=("data", "space"), shape=(2, 2))
        i, j = divmod(rank, 2)
        assert (mesh.axis_index("data"), mesh.axis_index("space")) == (i, j) and mesh.data_size == 2 and mesh.axis_size("space") == 2
        assert np.array_equal(pmesh.shard_batch(x, mesh), x[2 * i:2 * i + 2])
        got = pmesh.shard_batch({"hr": x}, pmesh.grid_sharding(mesh))["hr"]
        assert np.array_equal(got, x[2 * i:2 * i + 2, 4 * j:4 * j + 4])
        assert np.array_equal(pmesh.shard_batch(x, pmesh.row_sharding(mesh, "space")),
                              x[:, 4 * j:4 * j + 4])
    with pytest.raises(ValueError, match="image height 7 must divide over the 2-way"):
        pmesh.shard_batch(x[:, :7], pmesh.grid_sharding(mesh))
    serving = pmesh.get_mesh(["cpu"] * 8, axis_names=("data", "space"), shape=(4, 2))
    assert serving.shape == (4, 2) and serving.data_size == 4 and serving.axis_size("space") == 2
    with pytest.raises(pmesh.NotPorted, match=r"ROADMAP A\.13\.5"):
        pmesh.get_mesh(["cpu"] * 8, axis_names=("data", "space", "model"), shape=(2, 2, 2))
    with pytest.raises(ValueError, match="does not fit the mesh axes"):
        pmesh.get_mesh(["cpu"] * 4, shape=(2, 2))
    # GAN and QAT train on data,space (tests/test_torch_sp_gan.py): no item left for them
    assert "space" not in pmesh.ROADMAP_ITEMS and "space_gan_qat" not in pmesh.ROADMAP_ITEMS


def test_a_trainer_on_data_space_needs_its_shape_and_an_hr_height_that_splits(tmp_path):
    from facesr_torch.training.trainer import TrainerConfig

    with pytest.raises(ValueError, match="mesh_shape is required with multiple mesh_axes"):
        _trainer(tmp_path, [], [], mesh_axes="data,space")
    with pytest.raises(ValueError, match=r"needs 2 ranks and this process is alone"):
        _trainer(tmp_path, [], [], mesh_axes="data,space", mesh_shape=(1, 2))
    tr = _trainer(tmp_path, [], [], mesh_axes="data,space", mesh_shape=(1, 1))
    assert tr.mesh.shape == (1, 1) and tr._batch_divisor == 1
    tr.mesh = _grid_mesh()
    with pytest.raises(ValueError, match=r"image height 36 must divide over the 2-way 'space' "
                                         r"axis \(pick an hr_patch_size divisible by 8"):
        tr._batch_to_device(np.zeros((1, 36, 36, 3), np.float32))
    assert TrainerConfig().mesh_axes == "data"


@pytest.mark.parametrize("flags,ranks", [((), None), (("--dist-backend", "gloo"), 2),
                                         (("--device", "cpu"), 2)])
def test_a_plain_launch_refuses_more_ranks_than_cards_unless_gloo_is_asked_for(
        monkeypatch, tmp_path, flags, ranks):
    """On a host with one visible card a plain launch of a [1, 2] grid
    starts no two ranks over NCCL (one rank a card): it raises naming the
    counts. Sharing the card over gloo, or ranks on the CPU, is asked for."""
    from facesr_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["--config", str(tmp_path / "none.yaml"), "--mesh-axes", "data,space",
            "--mesh-shape", "1,2", *flags]
    if ranks is None:
        with pytest.raises(ValueError, match=r"needs 2 ranks and 1 card\(s\) are visible"):
            train_cli._ranks_to_start(argv)
    else:
        assert train_cli._ranks_to_start(argv) == ranks


@pytest.mark.parametrize("device,backend,local_ranks,want", [
    ("cuda:0", None, 1, "nccl"), ("cuda:0", None, 2, None), ("cuda:0", "gloo", 2, "gloo"),
    ("cpu", None, 4, "gloo")])
def test_ranks_share_a_card_only_over_gloo_asked_for(monkeypatch, device, backend, local_ranks,
                                                     want):
    """A rank's backend: NCCL on a card, gloo on the CPU, or the one named;
    more local ranks than cards over NCCL are refused, not moved to gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if want is None:
        with pytest.raises(ValueError, match="2 ranks on this host over NCCL"):
            pmesh._backend(torch.device(device), backend, local_ranks)
    else:
        assert pmesh._backend(torch.device(device), backend, local_ranks) == want


# ---------------------------------------------------------------------------
# serving: SpatialPredictor over a mesh


def _serving_model(**kw):
    return _model(**kw).eval()


def test_spatial_predictor_without_a_mesh_serves_on_one_device(monkeypatch):
    """mesh=None is one device however many cards are visible: the row
    split, which gives up the group kernel's trunk, is asked for by a mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    model = _serving_model()
    sp = SpatialPredictor(model, dtype=None, device="cpu")
    assert sp.n_devices == 1 and sp.devices == (torch.device("cpu"),)
    x = np.random.default_rng(6).random((1, 16, 8, 3), dtype=np.float32)
    sp(x)
    assert sp.last_exchanges == {}


@pytest.mark.parametrize("hw,used", [((64, 48), 8), ((52, 40), 4)])
def test_spatial_predictor_over_eight_cpu_entries_matches_jaxs_and_the_single_device(
        hw, used, capsys):
    import jax
    import jax.numpy as jnp

    from facesr.models import face_enhance_net as fen
    from facesr.parallel.serving import SpatialPredictor as JaxSpatialPredictor
    from facesr_torch.ckpt.weights import jax_params_from

    model = _serving_model()
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    jmodel = fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray, jax_params_from(model)))
    x = np.random.default_rng(7).random((1, *hw, 3), dtype=np.float32)
    want = JaxSpatialPredictor(jmodel, dtype=None)(x)  # the conftest's 8 CPU devices
    sp = SpatialPredictor(model, mesh=["cpu"] * 8, dtype=None)
    got = sp(x)
    with torch.no_grad():
        one = model(torch.from_numpy(x)).clamp(0, 1).numpy()
    assert got.shape == want.shape == (1, 4 * hw[0], 4 * hw[1], 3)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, one, atol=ATOL)
    # 15 convs (conv_first, 2 x (2 x 2 + 1), conv_after_body, 2 upsample, conv_last),
    # 4 SE means, one gather for the bicubic skip
    assert sp.last_exchanges == {"halo": 15, "sum": 4, "gather": 1}
    out = capsys.readouterr().out
    assert ("not divisible by the 8-device mesh" in out) == (used < 8)
    if used < 8:
        assert f"H={hw[0]} not divisible by the 8-device mesh — serving this shape on " \
               f"{used} device(s)" in out


def test_spatial_predictor_warns_once_per_h_for_a_prime_h(capsys):
    model = _serving_model()
    sp = SpatialPredictor(model, mesh=["cpu"] * 4, dtype=None)
    x = np.random.default_rng(9).random((1, 29, 16, 3), dtype=np.float32)
    out = sp(x)
    assert out.shape == (1, 116, 64, 3)
    msg = capsys.readouterr().out
    assert "H=29" in msg and "1 device" in msg
    sp(x)
    assert "H=29" not in capsys.readouterr().out
    sp(np.random.default_rng(9).random((1, 32, 16, 3), dtype=np.float32))
    assert "SpatialPredictor:" not in capsys.readouterr().out


def _unsharded(model, dtype, x, **kw):
    """The one-entry forward of ``dtype`` on ``x`` with the plain trunk (the
    sharded bf16 forward's trunk)."""
    kernel_trunk, model.kernel_trunk = model.kernel_trunk, False
    try:
        return SpatialPredictor(model, mesh=["cpu"], dtype=dtype, **kw)(x)
    finally:
        model.kernel_trunk = kernel_trunk


@pytest.mark.parametrize("dtype", [torch.bfloat16, "int8", "int8_full", "int8_full_calibrated"])
def test_spatial_predictor_serves_every_dtype_bitwise_its_unsharded_forward(dtype):
    model = _serving_model()
    rng = np.random.default_rng(8)
    kw = {}
    if dtype == "int8_full_calibrated":
        dtype, kw = "int8_full", {"calibration": rng.random((4, 16, 16, 3), dtype=np.float32)}
    x = rng.random((2, 48, 40, 3), dtype=np.float32)
    want = _unsharded(model, dtype, x, **kw)
    sp = SpatialPredictor(model, mesh=["cpu"] * 4, dtype=dtype, **kw)
    got = sp(x)
    assert got.shape == (2, 192, 160, 3)
    np.testing.assert_array_equal(got, want)
    assert sp.last_exchanges.get("max", 0) == (15 if dtype == "int8_full" and not kw else 0)


def _zoo_model(family):
    from facesr_torch.models.esrgan import RRDBNet, RRDBNetConfig
    from facesr_torch.models.transfer import TransferModelConfig, TransferSRModel

    if family == "esrgan":
        model = RRDBNet(RRDBNetConfig(num_feat=16, num_blocks=2, num_grow_ch=8), seed=0,
                        device="cpu")
    else:
        model = TransferSRModel(TransferModelConfig(backbone_blocks=2, freeze_blocks=2,
                                                    head_blocks=2, head_channels=16),
                                seed=0, device="cpu")
    return _perturbed(model).eval()


@pytest.mark.parametrize("family", ["esrgan", "transfer"])
def test_spatial_predictor_serves_the_zoo_in_f32(family):
    model = _zoo_model(family)
    x = np.random.default_rng(3).random((1, 32, 24, 3), dtype=np.float32)
    want = SpatialPredictor(model, mesh=["cpu"], dtype=None)(x)
    got = SpatialPredictor(model, mesh=["cpu"] * 4, dtype=None)(x)
    assert got.shape == (1, 128, 96, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, "int8", "int8_full"])
@pytest.mark.parametrize("family", ["esrgan", "transfer"])
def test_spatial_predictor_serves_the_zoo_in_every_dtype_bitwise(family, dtype):
    """The zoo at these widths runs no kernel (the transfer head at 16
    channels is the plain head), so both sides take the same ops."""
    model = _zoo_model(family)
    x = np.random.default_rng(6).random((1, 32, 24, 3), dtype=np.float32)
    want = SpatialPredictor(model, mesh=["cpu"], dtype=dtype)(x)
    got = SpatialPredictor(model, mesh=["cpu"] * 4, dtype=dtype)(x)
    assert got.shape == (1, 128, 96, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family,per_forward", [("custom", 6), ("transfer", 1)])
def test_the_group_kernel_runs_on_one_shard_and_not_on_two(monkeypatch, family, per_forward):
    """At C = 64 the bf16 eval forward's trunk (FaceEnhanceNet 6 x 1 x 64)
    or head (the transfer model) is the group kernel, one call a group: its
    plain version on the CPU. One mesh entry calls it; row shards take the
    plain trunk and call it never."""
    from facesr_torch.models import face_enhance_net as fen_mod
    from facesr_torch.models import transfer as tr_mod

    module = fen_mod if family == "custom" else tr_mod
    calls = []
    inner = module.fused_residual_group
    monkeypatch.setattr(module, "fused_residual_group",
                        lambda *a, **k: (calls.append(1), inner(*a, **k))[1])
    if family == "custom":
        model = FaceEnhanceNet(FaceEnhanceNetConfig(num_groups=6, blocks_per_group=1), seed=0,
                               device="cpu")
    else:
        model = tr_mod.TransferSRModel(tr_mod.TransferModelConfig(
            backbone_blocks=1, freeze_blocks=1, head_blocks=1), seed=0, device="cpu")
    model = _perturbed(model).eval()
    x = np.random.default_rng(4).random((1, 8, 8, 3), dtype=np.float32)
    SpatialPredictor(model, mesh=["cpu"], dtype=torch.bfloat16)(x)
    assert len(calls) == per_forward
    calls.clear()
    SpatialPredictor(model, mesh=["cpu"] * 2, dtype=torch.bfloat16)(x)
    assert calls == []


@pytest.mark.parametrize("control", ["zero_halo", "local_se_mean", "local_int8_scale"])
def test_each_planted_control_is_rejected_by_its_tolerance(monkeypatch, control):
    model = _serving_model()
    x = np.random.default_rng(5).random((1, 48, 40, 3), dtype=np.float32)
    dtype = "int8_full" if control == "local_int8_scale" else None
    want = SpatialPredictor(model, mesh=["cpu"], dtype=dtype)(x)
    if control == "zero_halo":
        def zeros(self, t, top, bottom):
            n, _, w, c = t.shape
            return t.new_zeros((n, top, w, c)), t.new_zeros((n, bottom, w, c))

        monkeypatch.setattr(spatial.ThreadShard, "_halo", zeros)
    elif control == "local_se_mean":
        monkeypatch.setattr(spatial, "mean", lambda t, dim=None: t.mean(dim=tuple(dim)))
    else:
        monkeypatch.setattr(spatial.ThreadShard, "_max", lambda self, t: t)
    got = SpatialPredictor(model, mesh=["cpu"] * 4, dtype=dtype)(x)
    if dtype is None:
        assert np.abs(got - want).max() > ATOL
    else:
        assert not np.array_equal(got, want)


def test_a_failing_shard_fails_the_call_instead_of_hanging_it(monkeypatch):
    model = _serving_model()
    sp = SpatialPredictor(model, mesh=["cpu"] * 2, dtype=None)
    real = spatial.ThreadShard._sum

    def planted(self, t):
        if self.index == 1:
            raise RuntimeError("planted failure on shard 1")
        return real(self, t)

    monkeypatch.setattr(spatial.ThreadShard, "_sum", planted)
    with pytest.raises(RuntimeError, match="planted failure on shard 1"):
        sp(np.zeros((1, 16, 16, 3), np.float32))


def test_thread_exchanges_stay_in_step_under_a_short_switch_interval():
    """More shards than cores exchanging many times with the interpreter
    switching threads every microsecond: every sum, max, halo and gather
    must see the values of the same exchange round (a slot overwritten
    early, or read late, breaks them)."""
    import os
    import threading

    n, rounds = max(8, (os.cpu_count() or 1) + 2), 60
    group = spatial.ThreadRows(["cpu"] * n)
    bad: list = []

    def work(shard):
        i = shard.index
        for r in range(rounds):
            x = torch.full((1, 2, 3, 1), float(100 * r + i))
            if shard.sum(x[0, 0, 0]).item() != sum(100 * r + j for j in range(n)):
                bad.append(("sum", i, r))
            if shard.max(x[0, 0, 0]).item() != 100 * r + n - 1:
                bad.append(("max", i, r))
            padded = shard.halo(x, 1, 1)
            above = padded[0, 0, 0, 0].item()
            below = padded[0, -1, 0, 0].item()
            if above != (100 * r + i - 1 if i else 0) or below != (100 * r + i + 1
                                                                    if i + 1 < n else 0):
                bad.append(("halo", i, r))
            if shard.gather(x)[0, ::2, 0, 0].tolist() != [100 * r + j for j in range(n)]:
                bad.append(("gather", i, r))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,), daemon=True) for s in group.shards()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
