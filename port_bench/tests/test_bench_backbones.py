"""Backbone families found by file: the configurations' ``archs`` build
what the name table built, a new family runs from added files alone, and
its attention enters the work tally."""

from __future__ import annotations

import copy
import filecmp
import hashlib
import importlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from port_bench import eval_cell, spec, weights, work
from port_bench.reference.collate import Caps
from port_bench.reference.models import pbnet as ref_pbnet
from port_bench.tests import tiny

CPU = torch.device("cpu")
CONFIGS = ("pbnet-34c", "pbnet-minkunet50")
CAPS = Caps(1, (1,), 1, 1, (1,), (1,), 1, 32)


def config(name: str) -> dict:
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


# sha256 of the state dict's layout (``name:shape;`` in order) and of the
# weights ``weights.make`` draws (each name, then its f32 bytes), recorded
# when the MinkUNet table built every UNet by name, before configurations
# stated their architectures under ``archs``.
RECORDED = {
    "pbnet-34c": {
        "layout": "2831ef7ad59d902f19ccba11f08c2dfd627472e1a5e31f6156fedda6f4c018f8",
        2**33 + 17: "c1d938c1fb1f2c91626cfc6e5e721ba06d961a1fca00c29ba4ee89b928310fab",
        2**31 + 5: "929aafab77b6351101b5ddde4f09d094f334c2818fa3b03db6973e49d1839a84",
    },
    "pbnet-minkunet50": {
        "layout": "4c9c117be6690c38ddd92b3a5b99bed29b5e8fb7bc5cae05eb99f6417ec0b596",
        2**33 + 17: "4a103691c3e5c44284b039a51fa325ac56c2729790cb7709566ae3f2331f9963",
        2**31 + 5: "e1de4a16785aae82b8d47a0ca75341c2dea90b03ba3576d88bafc85d9f87ca4d",
    },
}
# The work tally of the tiny cell's room at seed 2**34 + 21, recorded then too.
RECORDED_WORK = {
    "pbnet34c.eval-tta": {"ops": 36948666912, "ops_stage1": 25890522432,
                          "bytes_stage1": 182144432},
    "pbnet50.eval-tta": {"ops": 42497919520, "ops_stage1": 31439775040,
                         "bytes_stage1": 410610672},
}


def layout_digest(state: dict) -> str:
    return hashlib.sha256("".join(f"{k}:{tuple(v.shape)};" for k, v in state.items())
                          .encode()).hexdigest()


def weights_digest(wts: dict) -> str:
    h = hashlib.sha256()
    for k, v in wts.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_archs_build_the_recorded_layout_and_weights(name):
    cfg = config(name)
    model = ref_pbnet.PBNet(CAPS, device="meta", **weights.arch_kw(cfg))
    minkunet = importlib.import_module("port_bench.reference.backbones.minkunet")
    assert set(model.families.values()) == {minkunet}
    assert layout_digest(model.state_dict()) == RECORDED[name]["layout"]
    for seed in (2**33 + 17, 2**31 + 5):
        assert weights_digest(weights.make(cfg, seed, CPU)) == RECORDED[name][seed]


@pytest.mark.parametrize("name", sorted(RECORDED_WORK))
def test_the_work_tally_of_a_config_is_the_recorded_one(name):
    cell = tiny.eval_cell(name)
    seed = 2**34 + 21
    pool = cell.make_pool(cell.traffic, seed)
    wts = weights.make(cell.config, seed, CPU)
    _, counted = eval_cell.reference_outputs(cell, pool, wts, CPU, [0], count=True)
    assert counted[0] == RECORDED_WORK[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_ports_layout_is_the_references(name):
    from pbnet_torch.config import StaticShapes
    from pbnet_torch.models.pbnet import PBNet

    cfg = config(name)
    sh = StaticShapes(point_cap=32, voxel_caps=(32,) * 5)
    port = PBNet(sh, device=CPU, **weights.port_kw(cfg)).state_dict()
    ref = ref_pbnet.PBNet(CAPS, device="meta", **weights.arch_kw(cfg)).state_dict()
    assert list(port) == list(ref)
    assert [v.shape for v in port.values()] == [v.shape for v in ref.values()]


def test_an_architecture_the_config_does_not_state_is_refused():
    cfg = config("pbnet-34c")
    cfg["backbone_arch"] = "MinkUNet18A"
    with pytest.raises(KeyError, match="MinkUNet18A"):
        weights.make(cfg, 1, CPU)


def test_an_unknown_family_names_its_missing_file():
    cfg = config("pbnet-34c")
    cfg["archs"]["MinkUNet34C"]["family"] = "nosuch"
    with pytest.raises(FileNotFoundError, match=r"nosuch\.py"):
        weights.make(cfg, 1, CPU)


TOY = '''"""A toy backbone family: one k=3 sparse conv, one patch attention over
the level-0 rows in their order, one dense layer."""

import torch
from torch import nn

from port_bench import work
from port_bench.reference.nn.modules import SparseConv, SparseLinear


class Toy(nn.Module):
    def __init__(self, cin, cout, spec, generator, device):
        super().__init__()
        self.heads, self.head_dim, self.patch = spec["heads"], spec["head_dim"], spec["patch"]
        self.attend = spec["attend"]
        width = self.heads * self.head_dim
        self.conv = SparseConv(cin, width, 27, generator=generator, device=device)
        self.final = SparseLinear(width, cout, generator=generator, device=device)

    def attention(self, x, v):
        m, p, h, d = x.shape[0], self.patch, self.heads, self.head_dim
        pad = -m % p
        xp = nn.functional.pad(x, (0, 0, 0, pad)).view(-1, p, h, d).transpose(1, 2)
        vp = nn.functional.pad(v, (0, pad)).view(-1, p)
        s = (xp @ xp.transpose(-1, -2)) / d ** 0.5
        a = torch.softmax(s.masked_fill(~vp[:, None, None, :], float("-inf")), -1)
        y = (torch.nan_to_num(a) @ xp).transpose(1, 2).reshape(-1, h * d)[:m]
        if work.ACTIVE:
            work.attention(v, vp.sum(1).repeat_interleave(p)[:m], h, d)
        return torch.where(v[:, None], y, 0.0)

    def forward(self, topo, feats):
        v = topo.levels[0].valid
        x = torch.relu(self.conv(feats, topo.k3_maps[0], v))
        if self.attend:
            x = self.attention(x, v)
        return self.final(x, v)


def build(in_channels, out_channels, spec, generator, device):
    return Toy(in_channels, out_channels, spec, generator, device)


def scale(name, shape):
    if name == "conv.kernel":
        return (2.0 / (shape[0] * shape[2])) ** 0.5
    return 7.0 if name == "final.weight" else None


def const(name):
    return 0.125 if name == "final.bias" else 0.0
'''


def _toy_copy(tmp_path: Path):
    """A copy of ``port_bench/`` with a toy family, its configuration, a tiny
    eval traffic and limits added as new files; the cell and the files added."""
    base = tmp_path / "bench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    cfg = config("pbnet-34c")
    cfg.update(name="pbnet-toy", backbone_arch="Toy16")
    cfg["archs"]["Toy16"] = {"family": "toy", "heads": 2, "head_dim": 8, "patch": 64,
                             "attend": True}
    added = {
        "reference/backbones/toy.py": TOY,
        "configs/pbnet-toy.json": json.dumps(cfg),
        "traffic/eval-tiny.json": json.dumps(tiny.eval_cell().traffic),
        "limits/pbnet-toy.eval-tiny.json":
            (spec.HERE / "limits" / "pbnet34c.eval-tta.json").read_text(),
    }
    for rel, text in added.items():
        (base / rel).write_text(text)
    bench = copy.deepcopy(tiny.BENCH)
    bench["configs"].append({"name": "pbnet-toy", "source": "test",
                             "file": "port_bench/configs/pbnet-toy.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "pbnet-toy.eval-tiny", "config": "pbnet-toy",
                               "traffic": "eval-tiny", "chips": 1, "why": "test"})
    return spec.cell("pbnet-toy.eval-tiny", bench, base), base, set(added)


def test_a_new_family_runs_from_added_files_and_its_attention_is_counted(tmp_path):
    cell, base, added = _toy_copy(tmp_path)
    # the copy only adds files
    ours = {p.relative_to(spec.HERE).as_posix() for p in spec.HERE.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts and "_cache" not in p.parts}
    theirs = {p.relative_to(base).as_posix() for p in base.rglob("*") if p.is_file()}
    assert theirs == ours | added
    assert all(filecmp.cmp(spec.HERE / f, base / f, shallow=False) for f in ours)
    with pytest.raises(FileNotFoundError):
        spec.family("toy")  # found in the copy alone
    where = cell.config["backbones_dir"]
    assert spec.family("toy", where) is spec.family("toy", where)  # loaded once

    seed = 2**34 + 29
    pool = cell.make_pool(cell.traffic, seed)
    wts = weights.make(cell.config, seed, CPU)
    assert torch.equal(wts["MEUnet.final.bias"], torch.full((32,), 0.125))  # the family's rule
    assert 5.0 < float(wts["MEUnet.final.weight"].std()) < 9.0
    assert torch.equal(wts["D_Unet.final.bias"], torch.zeros(32))  # the table's rule
    with work.WorkCount(operand_bytes=2) as seen:
        res, counted = eval_cell.reference_outputs(cell, pool, wts, CPU, [0], count=True)
    assert set(res[0]) and torch.isfinite(res[0]["logits"]).all()
    conv, att, dense = seen.layers[:3]
    assert (conv.kind, conv.k, att.kind, dense.kind) == ("conv", 27, "attention", "dense")

    # by hand: the n valid level-0 rows come first, in patches of 64
    n, p, heads, head_dim = conv.rows_out, 64, 2, 8
    keys = sum(min(p, n - i) ** 2 for i in range(0, n, p))
    assert att.rows_in == att.rows_out == n and att.entries == keys
    assert att.ops == 4 * keys * head_dim * heads
    assert att.bytes == 4 * n * heads * head_dim * 2

    cell.config["archs"]["Toy16"]["attend"] = False
    _, without = eval_cell.reference_outputs(cell, pool, wts, CPU, [0], count=True)
    assert counted[0]["ops_stage1"] - without[0]["ops_stage1"] == att.ops
    assert counted[0]["bytes_stage1"] - without[0]["bytes_stage1"] == att.bytes
