"""Launchers (port of the reference `repro/launch/`). Ported so far: the
serving loop (`serve.py`); training and the dry-run are ROADMAP slice 9."""
