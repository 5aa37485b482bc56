"""Launchers, ported from `repro.launch`: the train and serve CLIs
(`train`, `serve`), meshes of cards (`mesh`), the partition rules
(`shardings`), the meta-tensor specs of every cell (`specs`) and the
per-card residency dry-run (`dryrun`)."""
