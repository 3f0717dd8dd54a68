"""Service-layer pieces of the port: so far only the partial_agg wire frame
(services/wire.py) that LocalCluster round-trips every partial through."""
