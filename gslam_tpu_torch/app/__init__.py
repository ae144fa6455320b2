"""Application layer (counterpart of ``gslam_tpu/app``): the component
registries and dataset dispatch by extension."""
