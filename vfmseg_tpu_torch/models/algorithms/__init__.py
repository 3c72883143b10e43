"""Training algorithms: the strong augmentations, DomainGeneral's masked
consistency wrapper (the DACS step is ``train/uda.py``)."""
