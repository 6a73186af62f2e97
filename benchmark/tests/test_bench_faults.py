"""The check catches a broken timed path: each fault planted in the
program underneath a whole run (the look for a card skipped, the CPU's
plain paths at a small size) makes ``correct`` come out false.

Fits (``mini1k.jobs``): ``unchanged``, every step returns its state
unchanged; ``altered``, the parameters an update produces have their
colours moved by 0.1.

Renders (``hd1m.render``): ``altered``, the frame a render produces has one
tile's colours moved by 0.1; ``stale``, a render returns the frame it made
before, of another population; ``half_splats``, a render leaves out the
second half of the population.

Every cell runs on one card and one image a call, so there is no exchange
between cards and no batch to leave half of."""

import pytest
import torch

from conftest import TINY, manifest


def _unchanged(monkeypatch, prog):
    loop = prog.loop
    monkeypatch.setattr(loop, "adam_update",
                        lambda params, grads, state, cfg: (params, state))


def _altered_fit(monkeypatch, prog):
    loop = prog.loop
    real = loop.adam_update

    def adam_update(params, grads, state, cfg):
        p, s = real(params, grads, state, cfg)
        return p.replace(color=(p.color + 0.1).clamp(0.0, 1.0)), s

    monkeypatch.setattr(loop, "adam_update", adam_update)


def _altered_frame(monkeypatch, prog):
    real = prog.render_flat.render_flat

    def render_flat(params, cfg):
        img, n = real(params, cfg)
        img = img.clone()
        img[:16, :32] += 0.1
        return img, n

    monkeypatch.setattr(prog.render_flat, "render_flat", render_flat)


def _stale(monkeypatch, prog):
    real = prog.render_flat.render_flat
    last = []

    def render_flat(params, cfg):
        out = real(params, cfg)
        prev = last[0] if last else out
        last[:] = [out]
        return prev

    monkeypatch.setattr(prog.render_flat, "render_flat", render_flat)


def _half_splats(monkeypatch, prog):
    real = prog.render_flat.render_flat

    def render_flat(params, cfg):
        half = params.n // 2
        keep = torch.arange(params.n) < half
        op = torch.where(keep.to(params.opacity.device), params.opacity,
                         torch.zeros_like(params.opacity))
        return real(params.replace(opacity=op), cfg)

    monkeypatch.setattr(prog.render_flat, "render_flat", render_flat)


FAULTS = {"unchanged": _unchanged, "altered_fit": _altered_fit,
          "altered_frame": _altered_frame, "stale": _stale,
          "half_splats": _half_splats}
CASES = [("mini1k.jobs", "unchanged"), ("mini1k.jobs", "altered_fit"),
         ("hd1m.render", "altered_frame"), ("hd1m.render", "stale"),
         ("hd1m.render", "half_splats")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_planted_fault_is_not_correct(monkeypatch, workload, fault):
    import run
    from lib import program

    prog = program.load()
    FAULTS[fault](monkeypatch, prog)
    res = run.run_cell(workload, 31337, 0.0, False, "cpu", prog=prog,
                       overrides=TINY[workload], log=lambda m: None,
                       man=manifest())
    assert not res["correct"], res["checks"]
