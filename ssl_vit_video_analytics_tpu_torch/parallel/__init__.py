"""Multi-process layouts on ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``): the ``data``, ``seq`` and ``client`` axes, and
model sharding over the ``expert``, ``model`` and ``pipe`` axes.

One process per card, launched by ``torchrun``; :func:`mesh.init_distributed`
joins the launcher's group (NCCL on a card, gloo on the CPU) and
:func:`mesh.make_mesh` lays the first ranks out over one or more named axes.
:mod:`collectives` holds the differentiable collectives and the gradient
reduction; :mod:`sp` the sequence-parallel attention; :mod:`shard` the
params cut over a model axis and the whole state gathered back (the
checkpoints); :mod:`ep`, :mod:`tp` and :mod:`pp` the expert, tensor and
pipeline layouts.
"""
