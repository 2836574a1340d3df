"""Typed configuration for the whole framework.

Replaces the reference's four YAML files loaded with ``yaml.safe_load`` at
module import time (``Code/config.yaml``, ``train_config.yaml``,
``process_config.yaml``, ``calibration_config.yaml``; ref ``module.py:26-48``,
``utils.py:35-38``) with one explicit dataclass tree:

  * no import-time coupling — models take the config (or derived
    hyperparameters) as constructor arguments;
  * derived scales (``scale_t = 3·kernel_sig_t``, ``eps = 5·kernel_sig_t``,
    ref ``module.py:40-41``) are computed in one place, as properties;
  * checkpoints carry a serialized snapshot of this config so inference
    reproduces training-time graph parameters (the reference's
    snapshot-in-checkpoint contract, ``train_GENIE_model.py:1580-1583``).

``load_config`` reads this framework's single YAML. ``yaml`` is imported
only inside :meth:`Config.save` and :func:`load_config`, so building a
``Config`` in code needs no YAML package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class RegionConfig:
    """Geographic domain. Ref: config.yaml:7-10, degree_padding :29."""

    name: str = "project"
    lat_range: tuple[float, float] = (39.3, 41.2)
    lon_range: tuple[float, float] = (-125.0, -123.0)
    depth_range: tuple[float, float] = (-40e3, 2e3)  # m, +up
    degree_padding: float = 0.25
    use_spherical: bool = False

    @property
    def lat_range_extend(self) -> tuple[float, float]:
        return (self.lat_range[0] - self.degree_padding, self.lat_range[1] + self.degree_padding)

    @property
    def lon_range_extend(self) -> tuple[float, float]:
        return (self.lon_range[0] - self.degree_padding, self.lon_range[1] + self.degree_padding)

    @property
    def center(self) -> tuple[float, float]:
        return (
            0.5 * (self.lat_range[0] + self.lat_range[1]),
            0.5 * (self.lon_range[0] + self.lon_range[1]),
        )

    def scale_offset(self, extend: bool = True):
        """(scale, offset) vectors mapping [0,1]^3 to the (padded) domain."""
        lat = self.lat_range_extend if extend else self.lat_range
        lon = self.lon_range_extend if extend else self.lon_range
        dep = self.depth_range
        scale = (lat[1] - lat[0], lon[1] - lon[0], dep[1] - dep[0])
        offset = (lat[0], lon[0], dep[0])
        return scale, offset


@dataclass
class VelocityModelConfig:
    """1-D velocity profile (vel_model_type=1). Ref: config.yaml:44-47."""

    depths: tuple[float, ...] = (-40e3, -35e3, -30e3, -25e3, -20e3, -15e3, -10e3, -5e3, 0.0, 5e3)
    vp: tuple[float, ...] = (7884, 7808, 7623, 7305, 6739, 6186, 5752, 5225, 4610, 4528)
    vs: tuple[float, ...] = (4430, 4388, 4286, 4108, 3788, 3477, 3233, 2935, 2590, 2544)


@dataclass
class GraphConfig:
    """Static graph/padding dimensions. Fixed-k neighbor counts mirror the
    reference (config.yaml:88-91); max_* are the TPU static-shape pads."""

    k_sta_edges: int = 8
    k_spc_edges: int = 15
    k_time_edges: int = 10
    k_spatial_attn: int = 10  # SpatialAttention knn, ref module.py:280
    k_pick_pairs: int = 16    # co-station pick pairs kept per pick (assoc attention)
    n_spatial_nodes: int = 500  # per grid, ref config.yaml:31
    n_grids: int = 5            # ref config.yaml:30
    max_sta: int = 128          # station padding
    max_picks: int = 512        # picks per training window (padded)
    max_src_query: int = 304    # association query sources (n_src_query=300 padded)
    max_spc_query: int = 4500   # detection query points, ref train_config n_spc_query
    # subgraph (sparse product) mode, ref process_utils.py:744-849
    use_subgraph: bool = False
    max_deg_offset: float = 1.5
    k_nearest_pairs: int = 30


@dataclass
class ModelConfig:
    """Model hyperparameters. Ref: config.yaml:82-103, module.py widths."""

    scale_rel: float = 30e3
    kernel_sig_t: float = 3.0  # shared with training labels
    n_hidden: int = 30
    n_latent: int = 30
    use_phase_types: bool = True
    use_absolute_pos: bool = False
    use_updated_model_definition: bool = False  # edge-featured DataAggregation
    # count-normalize the bipartite read-in station sum (layers.BipartiteReadIn).
    # False = the reference's raw sum. Normalizing divides out the coherent-
    # station COUNT — the primary detection signal — and collapsed the
    # detection heads to an input-independent background on the NC network.
    normalize_readin: bool = False
    t_win: float = 10.0
    n_heads_spatial: int = 5
    n_heads_assoc: int = 3

    @property
    def scale_t(self) -> float:
        return 3.0 * self.kernel_sig_t  # ref module.py:40

    @property
    def eps(self) -> float:
        return 5.0 * self.kernel_sig_t  # ref module.py:41


@dataclass
class SyntheticConfig:
    """On-device synthetic pick/event generator. Ref: train_config.yaml and
    generate_synthetic_data (train_GENIE_model.py:483-1234)."""

    T: float = 10800.0
    dt_rate: float = 30.0
    tscale: float = 3600.0
    max_rate_events: float = 50.0
    max_false_events: float = 3.0  # ratio of false to true picks
    miss_pick_fraction: tuple[float, float] = (0.05, 0.35)
    dist_range: tuple[float, float] = (15e3, 300e3)
    spc_random: float = 7.5e3
    spc_thresh_rand: float = 15e3
    sig_t: float = 0.025  # travel-time-proportional pick noise
    coda_rate: float = 0.035
    coda_win: tuple[float, float] = (0.0, 20.0)
    max_num_spikes: int = 10
    spike_time_spread: float = 0.15
    # false-pick "clean interval" carve-out (ref train_GENIE_model.py:
    # 748-755): zero the false-pick rate over one random contiguous
    # 10-30% stretch of the window so training also sees clutter-free
    # events (stabilizes attention on single-pick-per-station inputs)
    use_clean_data_interval: bool = True
    clean_interval_frac: tuple[float, float] = (0.1, 0.3)
    s_extra: float = 0.0
    total_bias: float = 0.03
    use_stable_association_labels: bool = True
    thresh_noise_max: float = 2.5
    min_misfit_allowed: float = 1.25
    min_sta_arrival: int = 4
    min_pick_arrival: int = 7
    n_sta_range: tuple[float, float] = (0.35, 1.0)
    fixed_subnetworks: bool = True
    use_preferential_sampling: bool = True
    use_extra_nearby_moveouts: bool = True
    use_shallow_sources: bool = False
    use_aftershocks: bool = True  # 10% clustered events, ref :567-579
    # reference-catalog spatial density sampling (ref :551-557, :92-97):
    # replace this fraction of uniform event positions with blurred draws
    # from a reference catalog (requires ref sources in the domain context)
    use_reference_spatial_density: bool = False
    frac_reference_catalog: float = 0.8
    spatial_sigma: float = 20000.0
    # spatially-correlated travel-time noise (ref :331-481, :642-652):
    # (rel_factor1, rel_factor2, bias_factor1, bias_factor2,
    #  correlation_scale_distance m, softplus_beta, softplus_shift)
    use_correlated_noise: bool = False
    corr_noise_params: tuple = (0.019731, 0.049616, 0.006930, 0.037159,
                                224205.7, 0.531071, -24.559947)
    max_events: int = 128   # static pad: events per T window
    n_false_max: int = 4096  # static pad: false picks per T window


@dataclass
class TrainConfig:
    """Training loop. Ref: train_config.yaml:10-16, train loop :1382-1881."""

    n_batch: int = 15
    n_steps: int = 15001
    n_spc_query: int = 4500
    n_src_query: int = 300
    lr: float = 1e-3
    loss_weights: tuple[float, float, float, float] = (0.1, 0.4, 0.25, 0.25)
    checkpoint_every: int = 1000
    src_t_kernel: float = 3.0
    src_x_kernel: float = 15e3
    src_depth_kernel: float = 15e3
    src_t_arv_kernel: float = 3.0
    src_x_arv_kernel: float = 15e3
    max_assoc_labels: int = 1500  # ref config.yaml:99
    restart_step: int = 0
    seed: int = 0
    # scan+remat windows instead of vmap: 1-window activation memory
    # (needed at large station×grid scales), ~2x backward FLOPs
    sequential_windows: bool = False
    # up-weight positive detection-label cells by (1 + boost·label):
    # counteracts the sparse-label gradient starvation of the detection
    # heads at large grids (0 = reference-equivalent plain MSE)
    positive_boost: float = 0.0
    # optional sensitivity (location-covariance) regularizer on the
    # association scores (ref train_GENIE_model.py:1792-1829, off by
    # default there too; the reference's weight is 2e-6)
    sensitivity_weight: float = 0.0
    sensitivity_sig_d: float = 0.15   # assumed pick uncertainty (s)


@dataclass
class ProcessConfig:
    """Continuous-day inference. Ref: process_config.yaml."""

    # sweep stride = t_win / step_size (s): 2 -> 5 s stride (the reference
    # process_config.yaml default "fast" mode), 5 -> 2 s ("accurate")
    step_size: float = 2.0
    thresh: float = 0.35
    thresh_assoc: float = 0.35
    use_only_one_grid: bool = False
    tc_win: float = 5.0
    sp_win: float = 17.5e3
    break_win: float = 15.0
    cost_assignment: float = 1.5
    # association windowing: "per_source" anchors one window per candidate
    # source at the trained query-time center (ref per-source forward_fixed,
    # process_continuous_days.py:1020-1065); "span" shares one window across
    # a t_win group (faster, but late sources are queried out of the trained
    # tq range — loses picks in dense sequences)
    assoc_mode: str = "per_source"
    max_sources_per_component: int = 15
    max_splits: int = 30
    min_required_picks: int = 8
    min_required_sta: int = 4
    n_query_grid: int = 10000
    n_rand_query: int = 112000
    refine_chunk: int = 16384       # offsets per device call in refinement
    offset_increment: int = 500
    trim_fraction: float = 0.2  # residual trimming in location


@dataclass
class TravelTimeConfig:
    """Travel-time engine. Ref: config.yaml:61-77, PINN trainer."""

    dx: float = 500.0
    d_deg: float = 0.005
    dx_depth: float = 500.0
    use_physics_informed: bool = True
    train_steps: int = 150001
    train_batch: int = 30000
    n_embed: int = 10
    use_topography: bool = False


@dataclass
class Config:
    region: RegionConfig = field(default_factory=RegionConfig)
    velocity: VelocityModelConfig = field(default_factory=VelocityModelConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    synth: SyntheticConfig = field(default_factory=SyntheticConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    process: ProcessConfig = field(default_factory=ProcessConfig)
    travel_time: TravelTimeConfig = field(default_factory=TravelTimeConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(tp, sub):
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in (sub or {}).items():
                if k not in fields:
                    continue
                f = fields[k]
                if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
                    kwargs[k] = build(f.type, v)
                elif isinstance(v, list):
                    kwargs[k] = tuple(v)
                else:
                    kwargs[k] = v
            return tp(**kwargs)

        sections = {f.name: f.default_factory for f in dataclasses.fields(cls)}
        kwargs = {}
        for name, factory in sections.items():
            kwargs[name] = build(type(factory()), d.get(name, {}))
        return cls(**kwargs)

    def save(self, path) -> None:
        import yaml

        Path(path).write_text(yaml.safe_dump(self.to_dict(), sort_keys=False))


def load_config(path: Optional[str] = None) -> Config:
    """Load a config YAML (or return defaults when ``path`` is None)."""
    if path is None:
        return Config()
    import yaml

    return Config.from_dict(yaml.safe_load(Path(path).read_text()) or {})
