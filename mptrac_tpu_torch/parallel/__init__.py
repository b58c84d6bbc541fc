"""The parallel layer: particle sharding over a mesh (``mesh``), the
spatial domain decomposition with parcel migration (``dd``) and the
multi-process runtime (``multihost``); counterpart of the JAX package's
``parallel/``."""
