"""Device ops of the port: codec, ingest (plain versions and the three
Hopper kernel wrappers), host fold, statistics and dispatch.  Nothing is
imported eagerly: each module is imported where it is used."""
