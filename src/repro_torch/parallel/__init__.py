"""Multi-device layer of the port (port of ``repro/parallel``): partition
rules over a ``DeviceMesh``, tensor-parallel kernel sites on local shards,
the int8 error-feedback gradient all-reduce and the GPipe pipeline."""
