"""The example drivers of the JAX repository (``examples/``), ported: each
module is the counterpart of ``examples/<same name>.py`` and runs as
``python -m caelo_tpu_torch.examples.<name>`` with that script's flags,
defaults, printed lines and JSON fields.

* ``register_pair_demo``: one synthetic pair through the front end;
* ``train_from_scratch_study``: both auto-encoders trained from scratch
  (optionally to a loss plateau, on hard-circuit scan caches) and scored
  on held-out easy and ray-cast pairs;
* ``hard_benchmark``: the full pipeline on the ray-cast circuit, gated on
  the reference's registration metrics, loop closure and the burst-rescue
  repair;
* ``loop_closure_demo``: a square loop whose drift loop closure removes;
* ``collect_validation``: rows of ``hard_benchmark`` JSONs in one file;
* ``kitti_golden``: the KITTI regression against the reference's golden
  row.

Every driver that runs the pipeline takes the command line's
``--platform`` (``cli._add_common``): the card by default, the CPU only
when asked; without a CUDA device the default fails.  None substitutes
random weights for the shipped ``.h5`` files.  Each exposes
``main(argv=None)`` and ``run(args, cfg)``, the latter taking the
``PipelineConfig`` to run at.  Outputs default to paths under ``runs/``.
"""
