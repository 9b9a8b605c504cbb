"""Solve routes: how a configuration's operator is built, set up and
solved through the port's public entries.  A configuration names its
route (``"route"``); each route is a module of its own here with

  build(cfg, u, gen, use_kernels) → state   operator and MG set-up
  solve(state, b) → (x, info)                one certified solve
  setup_outputs(state) → (V, X, Y, nvec, block) or None
  release(state)                             drop the program's state

``info`` holds what the solve reports (iterations, restarts), which the
per-layer metrics read; ``state.stats`` holds the set-up's own split.
"""
