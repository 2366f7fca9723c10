"""One module per model family: `families/<family>.py`, named by the
`family` key of a configuration file and found by `registry.family`.

A family module is the program's and the plain reference's side of a
cell; `serve.py` and `train.py` keep what every KITTI-style detector
shares (the frame pool, the closed-loop stream, warm-up, the windows,
the percentiles, the checked frames, the result). A new family is new
files only: its module, its reference package (a directory of its own
under `perfbench/` that imports nothing of the program), its
configuration files, and traffic files or metric readers where it needs
them. A module provides:

  reference_config(config_json) -> the reference's configuration object
  flops_per_frame(ref_cfg, mode) -> model FLOPs of one frame served
      (mode "serve") or trained (mode "train"), for the `mfu` readers

  Serving(env, pool_ref)          set-up of the program for serving:
      .frames                     the pool as the program takes it
      .roi                        the ROI (x_min .. z_max attributes) by
                                  which the largest frame is checked
      .prepare(frame) -> (example, batch)   host preprocessing
      .infer(batch) -> detections on the host
      .capture                    set True before a frame whose maps the
                                  comparison reads; .take_maps() returns
                                  them
      .trace(spans, ranges)       `--trace 1`: the spans `forward` (and
                                  the layers' own) and the op ranges
      .close()                    restores every patch, frees the model
      .weights, .ref_cfg          handed to the comparison

  Training(env, pool_ref)         set-up of the program's training loop:
      .run(on_step, wrap_batches, wrap_step)  runs the loop until
                                  `on_step(step)`, called after every
                                  step, raises; the loop's batch stream
                                  goes through `wrap_batches`, its step
                                  function through `wrap_step`
      .trace(ranges)              `--trace 1`: the op ranges
      .close(), .outputs() -> what `compare` reads

  compare(mode, run_out, device) -> {number: value}, the run's numbers
      against the reference (run_out: what the mode's `run` returned)
  control(mode, run_out, device) -> the control's numbers (readings.py)
  look(mode, run_out) -> readings beside the numbers (readings.py)

The limits of `correct` are the configuration file's, by mode; the
numbers a family compares are its own.
"""
