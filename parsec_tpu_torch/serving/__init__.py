"""parsec_tpu_torch.serving — the cross-rank serving fabric (ptfab).

The multi-tenant control plane over the native lanes: credit-based
remote admission on the ptcomm wire, mesh-wide QoS share reconciliation
nudging per-rank ptsched DRR weights, and a headroom-aware ingest
gateway.
"""

from .fabric import (FAB_STATS, FAB_WIRE_KEYS, ServingFabric,
                     fab_wire_sampler, tenant_id_for)
from .gateway import IngestGateway, serve_dtd_tenant
from .reconcile import ShareReconciler

__all__ = ["FAB_STATS", "FAB_WIRE_KEYS", "ServingFabric",
           "fab_wire_sampler", "tenant_id_for", "IngestGateway",
           "serve_dtd_tenant", "ShareReconciler"]
