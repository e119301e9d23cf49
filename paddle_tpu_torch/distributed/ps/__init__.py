"""The parameter server of the port (counterpart of
paddle_tpu/distributed/ps/): the wire codec (wire.py), the sharded
embedding service and its tables (embedding_service.py, tables.py), the
communicators, the MultiSlot dataset, the Downpour trainer with its dense
half on the card (trainer.py), the heter embeddings (heter.py) and the
fleet runtime wiring (runtime.py). The tables, services and communicators
are host programs; the trainers' dense half and the heter layers' rows
run on the card."""
from . import runtime  # noqa: F401
from .embedding_service import (EmbeddingTable, EmbeddingServer,  # noqa: F401
                                EmbeddingClient)
from .tables import (DenseTable, BarrierTable, TensorTable,  # noqa: F401
                     GeoSparseTable, SsdSparseTable)
from .communicator import (Communicator, AsyncCommunicator,  # noqa: F401
                           HalfAsyncCommunicator, SyncCommunicator,
                           GeoCommunicator)
from .dataset import MultiSlotDataset  # noqa: F401
from .trainer import DownpourTrainer, AsyncExecutor  # noqa: F401
from .heter import HeterEmbedding, PassCachedEmbedding  # noqa: F401
