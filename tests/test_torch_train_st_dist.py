"""Self-training under DDP (`tools/train_st.py --dist`,
openvocab/self_training.py) on the CPU: two gloo processes, each running
the CLI's main as torchrun would start it, against the CLI in one process
at the same global batch, and the extraction against the JAX package's
`extract_pseudo_labels`.

The run: tools/cfgs/synthetic_models/transfusion_synth_st.yaml at the
narrow widths of tests/test_torch_self_training.py, dropout 0, on 6
scenes (not a multiple of the global batch of 4) with the random steps of
its data pipeline off (the world augmentations, the point shuffle, and the
copy-paste of unknowns, whose queues live in each process:
`test_copy_paste_queues_live_in_each_process` pins that), two epochs with
st_warmup 1: epoch 0 trains one step on the seeded frustum labels, epoch 1
extracts frames 0-3 (each process two of them, frames r and r + 2) and
trains one step on both stores.

Tolerances: the stored boxes and scores 1e-5, labels and counts exact
(the same eval forward, its batch cut in two); the parameters and BN
buffers after the two steps 1e-5 absolute plus 1e-5 relative, as in
tests/test_torch_distributed.py, where the entry's last gradient is at
least 1e-2 of its leaf's largest (chip_smoke.py's DDP_GRAD_TOL) and above
rounding noise (1e-8); elsewhere Adam's step, the gradient over its own
magnitude, follows the gradient's last bits, which the sums over the
batch set in another order, and the entry is held within two steps of the
learning rate (one step moved heatmap_fc0.weight by 2.2e-5 at a gradient
3e-3 of its leaf's largest); the JAX extraction on the same weights those
of tests/test_torch_transfusion.py's detections (1e-5, labels and counts
exact).
"""

import copy
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from findnpropagate_torch import config as cfg_mod
from findnpropagate_torch.datasets import build_dataloader
from findnpropagate_torch.models import build_network
from findnpropagate_torch.openvocab import self_training
from findnpropagate_torch.openvocab.pseudo_labels import (
    PseudoLabelStore,
    PseudoLoader,
)
from findnpropagate_torch.tools import train_st
from findnpropagate_torch.utils.weights import to_jax_tree
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets import build_dataloader as jax_loader
from findnpropagate_tpu.models import build_network as jax_build
from findnpropagate_tpu.openvocab import pseudo_labels as jpl
from findnpropagate_tpu.openvocab import self_training as jst
from test_torch_self_training import NARROW, SYNTH_ST, seed_frustum_store

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300           # seconds each worker may take
SCENES = 6
BATCH = 4               # the global batch
WORLD = 2
OFF = {"NAME": "shuffle_points",
       "SHUFFLE_ENABLED": {"train": False, "test": False}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: tier-1 runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain(x):
    """EDicts and tuples as the dicts and lists yaml writes."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def st_cfg(copy_paste=False):
    """The narrow ST config: dropout 0, SCENES scenes, the point shuffle and
    the world augmentations off, the copy-paste of unknowns only with
    `copy_paste`."""
    cfg = cfg_mod.cfg_from_yaml_file(str(SYNTH_ST))
    cfg_mod.cfg_from_list(NARROW, cfg)
    cfg.MODEL.DENSE_HEAD.DROPOUT = 0.0
    dc = cfg.DATA_CONFIG
    dc.SYNTHETIC.NUM_SCENES = SCENES
    keep = ("load_frustum_pseudos", "load_selftrain_pseudos") + (
        ("unknowns_copy_paste",) if copy_paste else ())
    dc.DATA_AUGMENTOR.AUG_CONFIG_LIST = [
        a for a in dc.DATA_AUGMENTOR.AUG_CONFIG_LIST if a["NAME"] in keep]
    dc.DATA_PROCESSOR = [OFF if p["NAME"] == "shuffle_points" else p
                         for p in dc.DATA_PROCESSOR]
    return cfg


WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from findnpropagate_torch.openvocab import self_training
from findnpropagate_torch.openvocab.pseudo_labels import PseudoLabelStore
from findnpropagate_torch.tools import train_st

work, rank = sys.argv[1], int(os.environ["RANK"])
stamp = PseudoLabelStore.stamp_epoch


def stamp_epoch(self, epoch):
    with open(os.path.join(work, "stamps.jsonl"), "a") as f:
        f.write(json.dumps({{"rank": rank, "epoch": int(epoch)}}) + "\n")
    stamp(self, epoch)


PseudoLabelStore.stamp_epoch = stamp_epoch
run = self_training.train_model_st


def spy(detector, *a, **kw):
    out = run(detector, *a, **kw)
    torch.save({{"state": detector.state_dict(),
                "grads": {{n: p.grad for n, p in detector.named_parameters()}}}},
               os.path.join(work, f"rank{{rank}}.pt"))
    return out


self_training.train_model_st = spy
os.chdir(os.path.join(work, "ddp"))
sys.exit(train_st.main(json.loads(sys.argv[2])))
"""


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cli_args(work, tag):
    return ["--cfg_file", str(work / "st.yaml"), "--epochs", "2",
            "--st_warmup", "1", "--seed", "0", "--batch_size", str(BATCH),
            "--pseudo_path", str(work / "frustum"),
            "--st_path", str(work / f"st_{tag}"), "--device", "cpu"]


def run_ranks(work):
    """WORLD processes of `train_st --dist --device cpu` with torchrun's
    environment; each is killed when it outlives TIMEOUT."""
    script = work / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO)))
    (work / "ddp").mkdir()
    port = str(free_port())
    argv = json.dumps(["--dist"] + cli_args(work, "ddp"))
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                   MASTER_PORT=port, WORLD_SIZE=str(WORLD), RANK=str(r),
                   LOCAL_RANK=str(r), PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(work), argv], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def one_process(work, monkeypatch):
    """The CLI in this process at the same global batch: its final state
    and gradients, its stamps."""
    seen = {}
    run = self_training.train_model_st

    def spy(detector, *a, **kw):
        out = run(detector, *a, **kw)
        seen["state"] = {k: v.clone() for k, v in
                         detector.state_dict().items()}
        seen["grads"] = {n: p.grad for n, p in detector.named_parameters()}
        return out

    stamps = []
    stamp = PseudoLabelStore.stamp_epoch
    with monkeypatch.context() as m:
        m.setattr(self_training, "train_model_st", spy)
        m.setattr(PseudoLabelStore, "stamp_epoch", lambda self, e: (
            stamps.append(int(e)), stamp(self, e))[-1])
        (work / "one").mkdir()
        m.chdir(work / "one")
        assert train_st.main(cli_args(work, "one")) == 0
    seen["stamps"] = stamps
    return seen


def store(path):
    """frame id -> (boxes, scores, labels) of every npz in a store."""
    s = PseudoLabelStore(path)
    return {p.stem: s.load(p.stem) for p in sorted(Path(path).glob("*.npz"))}


def jax_extraction(work, cfg):
    """JAX extract_pseudo_labels over frames 0-3 at batch 4 with the
    weights the ranks extracted with (rank 0's checkpoint of epoch 0,
    carried by to_jax_tree), into a store of its own."""
    ckpt = next((work / "ddp" / "output").rglob("checkpoint_1.pt"))
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                batch_size=BATCH, training=False, prefetch=0)
    det = build_network(copy.deepcopy(cfg.MODEL), len(cfg.CLASS_NAMES), ds,
                        device="cpu")
    det.load_state_dict(torch.load(ckpt, weights_only=True)["model"])
    variables = {"params": to_jax_tree(det, "param"),
                 "batch_stats": to_jax_tree(det, "batch_stats")}
    data = JEDict(plain(dict(cfg.DATA_CONFIG, DATA_AUGMENTOR=None)))
    jds, loader, _ = jax_loader(data, list(cfg.CLASS_NAMES),
                                batch_size=BATCH, training=True, prefetch=0)
    jds.training = False
    jds.data_processor.training = False
    loader.shuffle = False
    jdet = jax_build(JEDict(plain(cfg.MODEL)), num_class=len(cfg.CLASS_NAMES),
                     dataset=jds)
    proc = jpl.PseudoProcessor(list(cfg.KNOWN_CLASS_NAMES),
                               self_training_folder=str(work / "st_jax"),
                               all_class_names=list(cfg.FULL_CLASS_NAMES))
    with jax.default_matmul_precision("highest"):
        jst.extract_pseudo_labels(jdet, variables, loader, proc, epoch=1)
    return store(work / "st_jax")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("st_dist")
    cfg = st_cfg()
    (work / "st.yaml").write_text(yaml.safe_dump(plain(cfg)))
    seed_frustum_store(work / "frustum", work / "st.yaml")
    logs = run_ranks(work)
    mp = pytest.MonkeyPatch()
    try:
        one = one_process(work, mp)
    finally:
        mp.undo()
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"work": work, "cfg": cfg, "logs": logs, "one": one,
            "ranks": ranks}


def test_the_ranks_store_the_one_process_frames(runs):
    """(a) The union of the ranks' npz files is the one-process store:
    frames 0-3 (the first BATCH * floor(SCENES / BATCH) frames; 4 and 5
    are the dropped short batch), equal labels and counts, boxes and
    scores within 1e-5; each rank saved its own frames, r and r + 2."""
    work = runs["work"]
    want = store(work / "st_one")
    got = store(work / "st_ddp")
    assert sorted(want) == sorted(got) == ["0", "1", "2", "3"]
    for fid, (b, s, lab) in want.items():
        gb, gs, glab = got[fid]
        np.testing.assert_array_equal(glab, lab, err_msg=fid)
        np.testing.assert_allclose(gb, b, rtol=1e-5, atol=1e-5, err_msg=fid)
        np.testing.assert_allclose(gs, s, rtol=1e-5, atol=1e-5, err_msg=fid)
    assert sum(len(lab) for _, _, lab in want.values()) > 0
    order = np.arange(SCENES)
    for r in range(WORLD):
        assert list(order[r::WORLD][:BATCH // WORLD]) == [r, r + WORLD]
    log0 = runs["logs"][0]
    assert "extracted pseudo labels for 4 frames over 2 processes" in log0
    assert "world size 2 (gloo), global batch 4, 2 per process" in log0


def test_rank_zero_alone_stamps_the_epoch(runs):
    """(b) epoch.txt written once, by rank 0, with the extraction's epoch;
    the one-process run stamps it once too."""
    work = runs["work"]
    stamps = [json.loads(line) for line in
              (work / "stamps.jsonl").read_text().splitlines()]
    assert stamps == [{"rank": 0, "epoch": 1}]
    assert runs["one"]["stamps"] == [1]
    assert PseudoLabelStore(work / "st_ddp").stamped_epoch() == 1


def test_the_ddp_steps_equal_the_one_process_steps(runs):
    """(c) After the warm-up step and the step on both stores, every rank's
    parameters and BN buffers lie within test_torch_distributed.py's
    tolerances of the one-process run's, the ranks' identical; rank 0's
    checkpoint is the last state."""
    want, grads = runs["one"]["state"], runs["one"]["grads"]
    lr = float(runs["cfg"].OPTIMIZATION.LR)
    for r, res in enumerate(runs["ranks"]):
        for k, v in want.items():
            err = (res["state"][k] - v).abs()
            tol = 1e-5 + 1e-5 * v.abs()
            g = grads.get(k)
            if g is not None:
                noise = (g.abs() < 1e-2 * g.abs().max()) | (g.abs() < 1e-8)
                tol = torch.where(noise, 2.1 * lr, tol)
            assert (err <= tol).all(), (r, k, float(err.max()))
    for k, v in runs["ranks"][0]["state"].items():
        assert torch.equal(v, runs["ranks"][1]["state"][k]), k
    ckpts = sorted(p.name for p in (runs["work"] / "ddp").rglob(
        "checkpoint_*.pt"))
    assert ckpts == ["checkpoint_1.pt", "checkpoint_2.pt"]


def queues(loader, frames=None):
    """The copy-paste state a PseudoLoader holds after one pass: each
    unknown class's queue (label, confidence and points of every sample),
    the sampler's seen-count EMA and the loader's score EMA. `frames`: feed
    these dataset rows in this order instead of iterating `loader`."""
    ds = loader.dataset
    if frames is None:
        for _ in loader:
            pass
    else:
        for i in frames:
            ds[int(i)]
    pl = ds.pseudo_loader
    return ({lbl: [(s.label, s.conf, s.points.tobytes()) for s in q]
             for lbl, q in pl.sampler.unknown_queue.items()},
            dict(pl.sampler.seen_per_class_ema), dict(pl.unknown_score_ema))


def copy_paste_loader(cfg, work, shard_id=0, num_shards=1, batch=BATCH):
    """The CLI's training loader (with the copy-paste step) over a fresh
    PseudoLoader reading the seeded frustum store, its dataset holding the
    PseudoLoader as `pseudo_loader`."""
    known = list(cfg.KNOWN_CLASS_NAMES)
    pl = PseudoLoader(known, pseudo_path=str(work / "frustum"),
                      self_train_path=str(work / "st_none"),
                      all_class_names=list(cfg.FULL_CLASS_NAMES))
    ds, loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=batch, training=True,
        seed=0, hooks=self_training.register_pseudo_hooks(pl), prefetch=0,
        shard_id=shard_id, num_shards=num_shards)
    ds.pseudo_loader = pl
    return loader


def test_copy_paste_queues_live_in_each_process(runs):
    """(d) The deliberate difference (ROADMAP.md section 3, PR 21): rank
    r's copy-paste queues and EMAs are those of one process fed only rank
    r's rows in the same order, from a dataset seeded alike, and not the
    queues of one process fed every row."""
    cfg, work = st_cfg(copy_paste=True), runs["work"]
    full = copy_paste_loader(cfg, work)
    full.set_epoch(0)
    everyone = queues(full)
    order = np.random.RandomState(0).permutation(SCENES)
    n = (SCENES // BATCH) * BATCH
    assert sum(len(q) for q in everyone[0].values()) > 0
    for r in range(WORLD):
        rank = copy_paste_loader(cfg, work, r, WORLD, BATCH // WORLD)
        rank.set_epoch(0)
        got = queues(rank)
        alone = copy_paste_loader(cfg, work)
        assert got == queues(alone, order[:n][r::WORLD])
        assert got != everyone


def test_each_rank_extracts_what_jax_extracts(runs):
    """(e) Each rank's stored detections for its frames equal the JAX
    extract_pseudo_labels' on the same frames with the same weights:
    labels and counts exact, boxes and scores 1e-5."""
    want = jax_extraction(runs["work"], runs["cfg"])
    got = store(runs["work"] / "st_ddp")
    assert sorted(want) == sorted(got)
    for fid, (b, s, lab) in want.items():
        gb, gs, glab = got[fid]
        np.testing.assert_array_equal(glab, lab, err_msg=fid)
        np.testing.assert_allclose(gb, b, rtol=1e-5, atol=1e-5, err_msg=fid)
        np.testing.assert_allclose(gs, s, rtol=1e-5, atol=1e-5, err_msg=fid)


def test_a_batch_the_world_size_does_not_divide_is_refused(tmp_path,
                                                          monkeypatch):
    """train_st keeps the reference's convention, --batch_size the global
    batch: at world size 2 a batch of 3 is refused before anything is
    built."""
    import findnpropagate_torch.tools.train_st as cli

    monkeypatch.setattr(cli, "init_distributed", lambda device: (0, 2))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="global batch"):
        cli.main(["--cfg_file", str(SYNTH_ST), "--batch_size", "3",
                  "--dist", "--device", "cpu"])
