"""The LM dry run (`launch/dryrun.py`), its roofline terms
(`launch/roofline.py`) and report tables (`launch/report.py`), on the
CPU: a rank of the production mesh runs the port's own step on meta
tensors through the shape-only mesh and the collectives' dry mode.

* the per-device argument bytes of a reduced train step on (2, 4) equal
  the reference's `memory_analysis().argument_size_in_bytes` (its
  subprocess is `test_torch_lm_mesh.py`'s, shared through
  `once_per_session`);
* a full-width cell (yi-9b decode_32k on (16, 16)) completes, and `--all`
  runs a cell in a subprocess and skips it when it is run again;
* the report renders its three tables from the JSONs the dry run wrote,
  each labelled as computed.
"""

from __future__ import annotations

import json

import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.launch import roofline as r_roofline
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import collectives, dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import report
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding

import torch_rank_cases as cases
from test_torch_lm_mesh import reference  # noqa: F401  (the fixture)


def test_train_argument_bytes_equal_the_references(reference):  # noqa: F811
    cfg = get_config("yi-9b").reduced()
    mesh = mesh_mod.abstract_mesh((2, 4))
    _, _, arg_bytes, draw = dryrun.cell_inputs(cfg, "train", cases.LM_SEQ,
                                               cases.LM_B, mesh)
    assert draw is None
    assert arg_bytes == reference["train_argument_bytes"]


@pytest.fixture(scope="module")
def decode_cell(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rec = dryrun.run_cell("yi-9b", "decode_32k", "single", str(out))
    return out, rec


def test_full_width_decode_cell_completes_on_meta(decode_cell):
    _, rec = decode_cell
    cfg = get_config("yi-9b")
    assert rec["status"] == "ok" and rec["computed"]
    assert rec["n_chips"] == 256 and (rec["seq"], rec["batch"]) == (32768,
                                                                   128)
    # a rank's weights: each leaf's shard of the serving model
    mesh = mesh_mod.abstract_mesh((16, 16))
    from repro_torch.launch import steps

    model = steps.abstract_params(cfg)
    specs = sharding.param_specs(mesh, cfg, model)
    weights = sum(sharding.shard_bytes(
        mesh, sharding.storage_shape(cfg, n, p.shape), specs[n], p.dtype)
        for n, p in model.named_parameters())
    mem = rec["memory"]
    assert weights < mem["argument_size_in_bytes"] < weights + 2**31
    assert mem["peak_live_bytes"] >= mem["argument_size_in_bytes"]
    coll = rec["collectives"]
    assert coll["count_by_op"]["all-gather"] > cfg.n_layers
    assert coll["bytes_by_link"] == {"network": coll["total_bytes"]}
    rf = rec["roofline"]
    assert rf["model_flops"] == pytest.approx(
        r_roofline.model_flops(r_get_config("yi-9b"), "decode", 32768, 128)
        / 256)
    assert rf["flops"] > rf["model_flops"] > 0
    assert rf["t_collective_s"] == pytest.approx(
        coll["total_bytes"] / rl.NETWORK_BW)
    assert rec["token_draw"]["hash_calls"] == 3 * 128  # K1: 3 levels


def test_report_renders_the_tables_it_reads(decode_cell, capsys):
    out, rec = decode_cell
    dryrun.run_cell("codeqwen1.5-7b", "long_500k", "single", str(out))
    recs = report.load(str(out))
    assert [r["cell"] for r in recs] == ["long_500k", "decode_32k"]
    roof = report.roofline_table(recs)
    assert "not measured" in roof and "fits in 80 GB" in roof
    assert "| yi-9b | decode_32k |" in roof and "skipped" in roof
    table = report.dryrun_table(recs)
    assert "not measured" in table and "| codeqwen1.5-7b | long_500k |" \
        in table
    notes = report.bottleneck_notes(recs)
    assert notes.startswith("* **yi-9b / decode_32k**")
    assert report.main([str(out)]) == 0
    printed = capsys.readouterr().out
    assert "## Roofline" in printed and "## Dry-run detail" in printed \
        and "## Bottlenecks" in printed
    assert report.main([str(out / "empty")]) == 1


def test_drive_all_runs_a_pending_cell_once(tmp_path, capsys):
    args = ["--all", "--arch", "xlstm-350m", "--cell", "decode_32k",
            "--out", str(tmp_path)]
    assert dryrun.main(args) == 0
    with open(tmp_path / "xlstm-350m__decode_32k__single__baseline.json"
              ) as f:
        assert json.load(f)["status"] == "ok"
    assert dryrun.main(args) == 0
    assert "[dryrun] 0 cells to run" in capsys.readouterr().out


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_model_flops_are_the_references(arch):
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 32768, 32),
                             ("decode", 32768, 128)):
        assert rl.model_flops(get_config(arch), kind, seq, batch) == \
            r_roofline.model_flops(r_get_config(arch), kind, seq, batch)


def test_dry_collectives_count_result_bytes_by_link():
    comm = collectives.Comm(mesh_mod.abstract_mesh((2, 16, 16)))
    t = torch.empty((4, 6), dtype=torch.bfloat16, device="meta")
    out = comm.all_gather(t, 1, ("data", "model"))
    assert out.shape == (4, 6 * 256) and out.device.type == "meta"
    # model first (16 x 6 x 4 x 2 bytes), then data (16x that)
    assert comm.count["all-gather"] == 2
    assert comm.nbytes["all-gather"] == 2 * 4 * 96 + 2 * 4 * 1536
    assert comm.link(("model",)) == "network"  # 16 ranks > 8 a host
    small = collectives.Comm(mesh_mod.abstract_mesh((2, 4)))
    assert small.link(("data", "model")) == "nvlink"
    r = comm.all_reduce(torch.empty(3, device="meta"), comm.dp)
    assert r.shape == (3,) and comm.count["all-reduce"] == 2
    roof = rl.LMRoofline(flops=rl.BF16_FLOPS, hbm_bytes=0.0,
                         collectives=rl.CollectiveStats(
                             {}, {}, {"nvlink": rl.NVLINK_BW,
                                      "network": rl.NETWORK_BW}))
    assert roof.t_compute == pytest.approx(1.0)
    assert roof.t_collective == pytest.approx(2.0)
    assert roof.bottleneck == "collective"


def test_a_meshed_step_leaves_no_moe_mesh_behind():
    """The MoE FFNs read the mesh's Comm only inside a meshed step: after
    one (here a dry train step of reduced qwen2-moe on (2, 4)) a
    one-device call in the same process finds none."""
    from repro_torch.models import moe

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    fn, args, _, _ = dryrun.cell_inputs(cfg, "train", 16, 8,
                                        mesh_mod.abstract_mesh((2, 4)))
    fn(*args)
    assert fn.comm.count["all-reduce"] > 0  # the switch loss's dp sums
    assert moe._MESH_CTX == {"dp": None, "tp": None, "tp_size": 1,
                             "comm": None}
