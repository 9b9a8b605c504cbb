"""The t-sharded solve on ``torch.distributed``: the ring (``mesh``), the
halo exchange (``halo``) and the rank's slab of the operator
(``sharded``)."""
