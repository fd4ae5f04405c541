"""Host-side matplotlib diagnostics (counterpart of ``mlmc_tpu/plot``)."""
from mlmc_tpu_torch.plot import plots
from mlmc_tpu_torch.plot import violinplot
