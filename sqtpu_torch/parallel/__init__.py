"""Training over several ranks: the port's counterpart of the JAX
package's ('data', 'grid') mesh (``sqtpu/parallel``).

* :mod:`sqtpu_torch.parallel.mesh`: the layout of ranks, its process
  groups and the collectives;
* :mod:`sqtpu_torch.parallel.sharded_losses`: the kernel losses over the
  layout (data-parallel K1/K2 and K4/K5, the grid-sharded K6);
* :mod:`sqtpu_torch.parallel.dryrun`: the multi-rank gates of
  ``__graft_entry__.dryrun_multichip``.
"""

from sqtpu_torch.parallel.mesh import Layout, init_layout  # noqa: F401
from sqtpu_torch.parallel.sharded_losses import (  # noqa: F401
    implicit_loss_gridsharded,
)
