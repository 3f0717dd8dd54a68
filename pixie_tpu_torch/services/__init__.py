"""Service-layer pieces of the port: so far the partial_agg wire frame
(services/wire.py) that LocalCluster round-trips every partial through, and
the cron runner's Ticker (services/cron.py) that the standing views'
background refresh runs on."""
