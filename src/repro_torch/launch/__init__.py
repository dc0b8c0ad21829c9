"""Launchers (port of the reference `repro/launch/`): the serving loop
(`serve.py`), the trainer (`train.py`), the production mesh (`mesh.py`),
the cells' steps (`steps.py`) and the dry-run (`dryrun.py`)."""
