from mlmc_tpu_torch.parallel.mesh import SampleMesh, sample_mesh
from mlmc_tpu_torch.parallel.sharded_estimate import (
    sharded_mlmc_step, sharded_synth_pipeline,
    sharded_synth_pipeline_from_noise)
