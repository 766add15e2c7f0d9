"""The port's config.py against the JAX package's: merge_new_config (with
a `_BASE_CONFIG_`), cfg_from_list (scalars, lists, comma lists, new keys)
and log_config_to_file, on transfusion_lidar.yaml and a seeker yaml. The
trees and the logged lines must be equal."""

import logging
from pathlib import Path

import pytest
import yaml

from findnpropagate_torch import config as tcfg
from findnpropagate_tpu import config as jcfg

ROOT = Path(__file__).resolve().parents[1]
YAMLS = ("tools/cfgs/nuscenes_models/transfusion_lidar.yaml",
         "tools/cfgs/nuscenes_models/nuscenes_box_seeker_proposals.yaml")
OVERRIDES = {
    YAMLS[0]: ["OPTIMIZATION.LR", "0.003", "MODEL.DENSE_HEAD.NUM_PROPOSALS",
               "100", "DATA_CONFIG.POINT_CLOUD_RANGE", "-51.2,-51.2,-5,"
               "51.2,51.2,3", "MODEL.NEW_KEY.DEEP", "[1, 2]"],
    YAMLS[1]: ["MODEL.DENSE_HEAD.PARAMS.max_dist", "60",
               "MODEL.DENSE_HEAD.PARAMS.nms_3d", "0.5",
               "MODEL.DENSE_HEAD.PREDS_PATHS", "a.json,b.json",
               "CLASS_NAMES", "['car']"],
}


def plain(tree):
    """EDict trees of either package -> plain dicts (the classes differ)."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(plain(v) for v in tree)
    return tree


@pytest.mark.parametrize("path", YAMLS)
def test_merge_new_config_matches_jax(path, monkeypatch):
    monkeypatch.chdir(ROOT)
    with open(path) as f:
        new = yaml.safe_load(f)
    got = tcfg.merge_new_config(tcfg.EDict(), new)
    ref = jcfg.merge_new_config(jcfg.EDict(), new)
    assert plain(got) == plain(ref)
    assert "POINT_CLOUD_RANGE" in got.DATA_CONFIG     # the base was merged
    # merging into a tree that already holds keys, with a scalar replaced
    # by a dict
    got = tcfg.merge_new_config(tcfg.EDict({"MODEL": 1, "KEEP": 2}), new)
    ref = jcfg.merge_new_config(jcfg.EDict({"MODEL": 1, "KEEP": 2}), new)
    assert plain(got) == plain(ref) and got.KEEP == 2


@pytest.mark.parametrize("path", YAMLS)
def test_cfg_from_list_matches_jax(path, monkeypatch):
    monkeypatch.chdir(ROOT)
    got = tcfg.cfg_from_list(OVERRIDES[path], tcfg.cfg_from_yaml_file(path))
    ref = jcfg.cfg_from_list(OVERRIDES[path],
                             jcfg.cfg_from_yaml_file(path, jcfg.EDict()))
    assert plain(got) == plain(ref)
    with pytest.raises(AssertionError):
        tcfg.cfg_from_list(["ODD"], got)


@pytest.mark.parametrize("path", YAMLS)
def test_log_config_to_file_matches_jax(path, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    tree_t = tcfg.cfg_from_yaml_file(path)
    tree_j = jcfg.cfg_from_yaml_file(path, jcfg.EDict())
    tcfg.log_config_to_file(tree_t)
    printed_t = capsys.readouterr().out
    jcfg.log_config_to_file(tree_j)
    assert printed_t == capsys.readouterr().out and printed_t

    lines = {}
    for name, mod, tree in (("t", tcfg, tree_t), ("j", jcfg, tree_j)):
        logger = logging.getLogger(f"cfg_parity_{name}")
        records = []
        handler = logging.Handler()
        handler.emit = lambda r, records=records: records.append(
            r.getMessage())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
        try:
            mod.log_config_to_file(tree, pre="x", logger=logger)
        finally:
            logger.removeHandler(handler)
        lines[name] = records
    assert lines["t"] == lines["j"] and len(lines["t"]) > 10
