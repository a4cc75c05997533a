"""Training substrate, the port of ``repro.train``: the optimizer
(``optim``), checkpointing (``checkpoint``), the loop with checkpoint/restart
and preemption (``loop``), straggler and preemption handling
(``stragglers``), gradient compression (``compress``) and elastic re-mesh
planning (``elastic``)."""
