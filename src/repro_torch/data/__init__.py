from repro_torch.data.corpus import synthetic_corpus  # noqa: F401
from repro_torch.data.partition import (  # noqa: F401
    iid_partition, length_dirichlet_partition, partition_dataset,
)
from repro_torch.data.pipeline import (  # noqa: F401
    ClientDataLoader, make_client_loaders, stack_client_batches,
)
from repro_torch.data.tokenizer import HashTokenizer  # noqa: F401
