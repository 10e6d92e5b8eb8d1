"""The plain reference: float32 PyTorch with no kernel, cache or code of
the program. `arch` reads a configuration file, `seanet` and `rvq` are the
model, `train` the training step, `codec` the judge of served batches."""
