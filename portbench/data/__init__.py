"""Data sources, one module each, named by a configuration's `data.kind`.

Each module has `load(spec, seed, device)`, which returns the train and
validation arrays (B, T, I), (B, O), (Bv, T, I), (Bv, O) as float32
tensors on `device`.  `spec` is the configuration's `data` block with its
`sizes` merged in.
"""
