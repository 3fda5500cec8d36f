"""The check's two sides at smoke size on the CPU: the lower-precision
control, and the timed path broken underneath a run (the chip look
skipped, everything else as a run drives it), each come out not correct
against the cells' limits; the sound run comes out correct."""
import math

import pytest
import torch

from portbench import smoke

CELLS = ("vggt1b-s8-poisson", "phi3mini-w4a8-score", "vggt1b-s32-backlog")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cell):
    _, line = smoke.run(cell)
    assert line["correct"], line["checks"]
    _, ctl = smoke.run(cell, control=True)
    assert not ctl["correct"], ctl["checks"]


def _vggt_fault(kind):
    from repro_torch.models import vggt

    orig_block, orig_fwd = vggt._block, vggt.forward

    def block(p, cfg, x, kv_mask=None):  # every global block returns its input
        return x if x.shape[1] > 21 else orig_block(p, cfg, x, kv_mask)

    def forward(cfg, params, x, **kw):
        if kind == "half_batch":  # rows past the first half take the mean of the rest
            out = orig_fwd(cfg, params, x, **kw)
            h = (x.shape[0] + 1) // 2
            return {k: torch.cat([v[:h], v[:h].mean(0, keepdim=True).expand_as(v[h:])])
                    for k, v in out.items()}
        out = orig_fwd(cfg, params, x, **kw)  # "answer": one scene's depth altered
        out["depth"] = torch.cat([out["depth"][:1] * 1.1, out["depth"][1:]])
        return out

    return ("_block", block) if kind == "unchanged" else ("forward", forward)


def _lm_fault(kind):
    from repro_torch.models import lm

    orig_layer, orig_fwd = lm._apply_layer, lm.forward

    def layer(cfg, lp, k, fk, x, *, cache=None, **kw):  # every layer returns its input
        return x, cache

    def forward(cfg, params, inputs, **kw):
        logits, cache = orig_fwd(cfg, params, inputs, **kw)
        if kind == "half_batch":
            h = (logits.shape[0] + 1) // 2
            rest = logits[:h].mean(0, keepdim=True).expand_as(logits[h:])
            return torch.cat([logits[:h], rest]), cache
        logits = logits.clone()
        logits[:, -1, 7] += 100.0  # the served token altered where it is produced
        return logits, cache

    return ("_apply_layer", layer) if kind == "unchanged" else ("forward", forward)


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, kind, monkeypatch):
    """Each fault at the cell's own number of checked requests; the s8
    rate and the LM's clients are raised so that smoke-size forwards,
    which take milliseconds, still share their calls as the card's do."""
    if cell.startswith("vggt"):
        from repro_torch.models import vggt as mod

        name, fn = _vggt_fault(kind)
        kw = dict(rate_per_s=12.0) if cell == "vggt1b-s8-poisson" else {}
    else:
        from repro_torch.models import lm as mod

        name, fn = _lm_fault(kind)
        kw = dict(clients=4)
    monkeypatch.setattr(mod, name, fn)
    run, line = smoke.run(cell, **kw)
    assert max(b.real for b in run.batches) > 1  # some call shared by several requests
    assert not line["correct"], line["checks"]
    assert any(c["value"] is not None and (not math.isfinite(c["value"]) or c["value"] > c["limit"])
               for c in line["checks"].values()), line["checks"]
