"""Runtime substrates: checkpointing, data pipeline, fault tolerance.

The reference's ``runtime/distributed.py`` is a deprecated shim over its
sharding API and is not ported."""
