"""Parallelism over ``torch.distributed`` (counterpart of the JAX
``parallel`` package): meshes of ranks and their collectives (``mesh``),
process-group set-up (``multihost``), one event's graph sharded with halo
exchange (``halo``), the sharded condensation loss (``sharded_tc``) and
trainers (``sharded_model``), data parallelism (``dp``) and both at once
(``mesh2d``)."""
