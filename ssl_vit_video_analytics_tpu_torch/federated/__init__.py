from .core import (
    fedavg_aggregate, broadcast_tree, select_clients,
    make_parallel_client_update, run_fedavg_round, run_fedavg,
)
from .comm_cost import (
    model_size_bytes, bytes_to_mb, estimate_comm_mb_per_round, estimate_raw_upload_mb,
)
