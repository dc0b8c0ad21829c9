"""Launchers (port of the reference `repro/launch/`): the serving loop
(`serve.py`) and the trainer (`train.py`). `steps.py` and the dry-run are
ROADMAP slice 9's."""
