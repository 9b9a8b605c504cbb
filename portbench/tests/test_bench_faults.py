"""The run with its timed path broken underneath: the harness, past its
look for a card, sees ``correct`` come out false for each fault a solve
cell can have — an answer altered where it is produced, and a solve
that returns its state unchanged (x = 0) — and, in the set-up cell, a
coarse operator or a V altered where the set-up produces them, and a
set-up whose null-vector solves are cut (Gaussian vectors in their
place).  (Cells
of one source a unit on one chip have no batch to halve and no exchange
between chips to leave out.)"""

import importlib
import time

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.tiny import tiny


def _run(name, monkeypatch, route_patch):
    spec, cell, cfg, traffic = tiny(name)
    route = importlib.import_module(f"portbench.routes.{cfg['route']}")
    route_patch(monkeypatch, route)
    return run_cell(spec, cell, 2**33 + 5, 0.5, False, torch.device("cpu"),
                    cfg=cfg, traffic=traffic, use_kernels=False,
                    t_start=time.perf_counter())


def _solve_fault(kind):
    def patch(monkeypatch, route):
        real = route.solve

        def broken(state, b):
            x, info = real(state, b)
            if kind == "altered":
                x = x.clone()
                x.view(-1)[17] += 1e-3 * x.abs().max()
            else:
                x = torch.zeros_like(x)
            return x, info
        monkeypatch.setattr(route, "solve", broken)
    return patch


@pytest.mark.parametrize("kind", ["altered", "unchanged"])
@pytest.mark.parametrize("name", ["tmc32.mg_solves", "tmc32.configs",
                                  "tmc48.dc_solves"])
def test_broken_solve_is_not_correct(name, kind, monkeypatch):
    out = _run(name, monkeypatch, _solve_fault(kind))
    assert out["correct"] is False
    assert out["failed"] >= 1


@pytest.mark.parametrize("part", ["coarse", "v"])
def test_broken_setup_is_not_correct(part, monkeypatch):
    def patch(monkeypatch, route):
        real = route.setup_outputs

        def broken(state):
            v, x, y, nvec, block = real(state)
            if part == "coarse":
                y = y.clone()
                y[3] *= 1.001
            else:
                v = v.clone()
                v[..., 0, :] *= 1.001
            return v, x, y, nvec, block
        monkeypatch.setattr(route, "setup_outputs", broken)
    out = _run("tmc32.configs", monkeypatch, patch)
    assert out["correct"] is False
    bad = {k.split(".")[0] for k, c in out["checks"].items()
           if not c["value"] <= c["limit"]}
    # an altered V also breaks the product V†MV it no longer matches
    assert bad == ({"galerkin"} if part == "coarse"
                   else {"v_ortho", "galerkin"})


def test_setup_without_null_solves_is_not_correct(monkeypatch):
    from portbench.controls import gaussian_null_vectors

    def patch(monkeypatch, route):
        real = route.build

        def cut(cfg, u, gen, use_kernels=True, null_vectors=None):
            fake = gaussian_null_vectors(cfg, cfg["mg"]["nvec"], 3, u.device)
            return real(cfg, u, gen, use_kernels, null_vectors=fake)
        monkeypatch.setattr(route, "build", cut)
    out = _run("tmc32.configs", monkeypatch, patch)
    assert out["correct"] is False
    bad = {k.split(".")[0] for k, c in out["checks"].items()
           if not c["value"] <= c["limit"]}
    # V is orthonormal and D_c its Galerkin product: only null_hop sees it
    assert bad == {"null_hop"}
