from dcarl_tpu_torch.data import datasets as datasets
from dcarl_tpu_torch.data import sampling as sampling
