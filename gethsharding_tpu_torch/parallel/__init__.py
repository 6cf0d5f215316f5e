"""The shard mesh (`mesh.py`), the per-period pipelines (`period.py`) and
the fused period step of BASELINE config 5 (`stress.py`), on one device or
over a mesh of device slots; `dryrun.py` runs them across layouts."""
