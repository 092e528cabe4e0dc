"""The parallel layer on ``torch.distributed``: a named mesh of ranks
(``mesh.py``), the collectives with their autograd transposes
(``collectives.py``), attention over (batch, heads) shards
(``sharded_attention.py``) and over sequence shards (``ring_attention.py``),
and a process launcher for one machine (``launch.py``)."""
