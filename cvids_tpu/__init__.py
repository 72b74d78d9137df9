"""cvids_tpu — collaborative visual-inertial SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the CVIDS
reference (collaborative multi-agent VI-SLAM server + dense TSDF mapping):

- ``geometry``: batched SO(3)/SE(3)/4-DoF algebra
- ``camera``:   pinhole + radtan camera models
- ``ops``:      compute kernels (features, matching, RANSAC, plane-sweep,
                SGM, Bayesian depth filter, TSDF, marching cubes)
- ``vio``:      per-agent front-end (IMU preintegration, sliding-window BA)
- ``server``:   collaborative pose graph (loop closure, PCM, 4-DoF solver)
- ``dense``:    multi-view depth estimation pipeline
- ``mapping``:  chunked TSDF fusion + meshing
- ``parallel``: device-mesh sharding helpers
- ``io``:       dataset replay, synthetic worlds, trajectory formats
"""

__version__ = "0.1.0"
