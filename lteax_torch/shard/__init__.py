"""The multi-device layer over ``torch.distributed``: the rank mesh and
its launcher (``mesh``), the halo exchange (``halo``), the sharded
decoders (``pipeline``), the channel-sharded prescan (``scanner``) and the
multi-rank dry run (``dryrun``)."""
