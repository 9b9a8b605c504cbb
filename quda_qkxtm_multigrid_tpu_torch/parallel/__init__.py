"""The sharded solve on ``torch.distributed``: the t-ring or (Gt, Gz, Gw)
grid (``mesh``), the halo exchange (``halo``), the rank's box of the
operator (``sharded``) and the Schwarz preconditioners (``schwarz``)."""
