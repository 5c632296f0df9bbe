"""Sharding rules, placements and one rank's collectives
(``sharding.py``)."""
