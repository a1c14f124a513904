"""The plain reference: the τ-averaging rounds (`train.py`) in plain
PyTorch, from the benchmark's weights and rows. It imports nothing of the
port.

Each configuration `backend` has a module `reference/<backend>.py`, found
by its name (`load.reference`), that owns what both sides need of that
kind of configuration:

  shapes(config)          the shapes of its blobs or layers at the
                          configuration's batch
  weight_leaves(config)   [(key, shape, filler)] of every learned leaf, in
                          the program's layout, keys and order; a filler
                          is {"type": "gaussian", "std", "mean"} or
                          {"type": "constant", "value"} (`inputs.py`)
  optimizer(config)       an object with `zeros(params)` (its state) and
                          `update(params, state, grads, it)` (in place)
  loss(config, weights, rows, mode, step_keys)
                          one step's loss, differentiable in `weights`:
                          `rows` is step t's slice of the round's arrays
                          (`kinds/<kind>.py`), each with the step's
                          samples on axis 0; `mode` a precision of
                          `precision.py`; `step_keys` = (seed, round, rank,
                          step), for whatever the step draws
  unit_axis(config, key)  the output axis of leaf `key` (the check's
                          units; a 1-D leaf is one unit: `compare.py`)
  forward_flops_per_sample(config)
                          the forward's FLOPs for one sample (`flops.py`)
"""
