"""Models, one module each, named by a configuration's `"model"` key
(`spec.model`).  Everything that depends on the model lives in its
module; the rest of the harness knows traffic kinds, data, seeds and
metrics only.  A module has:

  * `RHO_KEYS`: the penalty keys, in the order of the rows of the rho
    search's candidate grid (jobs.candidate_grid) and of the reference;
  * `weights(seed, job, sizes, device)`: job `job`'s initial weights, a
    tuple of tensors made on `device` from the run's seed
    (weights.stream_seed); check.weight_gap compares the tuples leaf by
    leaf;
  * `train(config, sizes, data, weights, epochs, device, control)`: a
    training run on the program, as {'train', 'val': each epoch's losses,
    the initial ones first, float64 on the host; 'weights': the final
    tuple};
  * `search(config, sizes, data, weights, candidates, epochs, device,
    control)`: a rho search on the program, as {'train', 'val': each
    candidate's final losses; 'order': the candidates, best first};
  * `reference_train(config, data, weights, epochs)` and
    `reference_search(config, data, weights, candidates, epochs)`: the
    same jobs on the plain reference (reference/), in its own layout,
    from the same weights and data; a training run adds 'initial', the
    weights it started from;
  * `epoch_ops(sizes, reference_rules)`: the operations of one epoch of
    one instance (readers.mfu);
  * `fault_targets()`: {'step': ..., 'loss': ...}, the (module, attribute)
    pairs of the program's epoch step and of its loss function, which
    faults.planted patches.  The step is called as
    `step(state, x, y, rules)`, the batch on the last axis of x and y, and
    returns the new state, a NamedTuple with an `epoch` count; the loss
    function returns (train, val).

`config` is the configuration's file, `sizes` its sizes (smaller in the
CPU tests), `data` the four arrays of its data source (data/), and
`control` switches on the configuration's lower-precision path of the
program.
"""
