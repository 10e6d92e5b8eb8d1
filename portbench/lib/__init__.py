"""The harness: the run (`harness`), the cells' files (`spec`), the
drivers by traffic kind (`<kind>_cell`: `train_cell`, `codec_batch_cell`),
seeded inputs (`inputs`), the profiler window (`trace`) and the port's
launch counters (`launches`)."""
