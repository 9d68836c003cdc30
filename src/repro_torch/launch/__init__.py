"""Launchers (``repro/launch``): ``serve``, ``steps`` (the LM train,
eval, prefill and decode steps), ``train`` (training on a mesh),
``dryrun`` and ``profile_cell`` (the pod dry run) over ``mesh``,
``sharding`` and ``specs``, ``train_lm`` (``examples/train_lm.py``'s
counterpart), and the examples' counterparts beside them."""
