"""Measurement tools of the port, counterparts of the repo's ``tools/``:
``residency_live`` (the two-namespace residency drill), ``live_load``
(concurrent HTTP load with the per-stage breakdown of ``/metrics``) and
``phrase_cost_validate`` (the phrase router's choices against measured
host and stream times), and the port's own ``routing_fit`` (the
router's constants fitted from those readings; it reads files and runs
anywhere).  Each runs as ``python3 -m fugu_tpu_torch.tools.<name>``, on
the card unless asked for the CPU."""
