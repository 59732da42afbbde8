"""Multi-process layouts on ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``): the ``data``, ``seq`` and ``client`` axes.

One process per card, launched by ``torchrun``; :func:`mesh.init_distributed`
joins the launcher's group (NCCL on a card, gloo on the CPU) and
:func:`mesh.make_mesh` builds a one-axis :class:`mesh.Mesh` over the first
n ranks. :mod:`collectives` holds the differentiable all-reduce and
all-gather and the gradient reduction; :mod:`sp` the sequence-parallel
attention. Model sharding (tensor, pipeline and expert parallelism) is
ROADMAP item 15c.
"""
