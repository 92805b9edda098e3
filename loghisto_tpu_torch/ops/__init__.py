"""Device ops of the port: codec, ingest, the paged store and the window
merge (plain versions and the Hopper kernel wrappers), host fold,
statistics and dispatch.  Nothing is imported eagerly: each module is
imported where it is used."""
