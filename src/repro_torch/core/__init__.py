"""Core DFR math: types, masking, reservoir, DPRR, backprop, ridge, online,
the offline classifier (dfr), the hyperparameter search (candidates,
population, grid_search) and the LM-feature readout (readout).

The reference's public names that are ported, re-exported as
``repro.core`` exports them.  Nothing here imports the kernels: they import
core, and core reaches them inside its functions."""
from repro_torch.core.types import (  # noqa: F401
    DFRConfig,
    DFRParams,
    RegressionBatch,
    RidgeState,
    TimeSeriesBatch,
)
from repro_torch.core.masking import make_mask, apply_mask  # noqa: F401
from repro_torch.core.reservoir import (  # noqa: F401
    run_reservoir,
    reservoir_step,
    reservoir_step_naive,
    ring_matrix,
    ring_powers,
)
from repro_torch.core.dprr import (  # noqa: F401
    compute_dprr,
    r_tilde,
    shifted_states,
)
from repro_torch.core.ridge import (  # noqa: F401
    ridge_solve,
    ridge_solve_batched,
    ridge_gaussian,
    ridge_cholesky_packed,
    ridge_cholesky_blocked,
    ridge_cholesky_batched,
    accumulate_ab,
    regularize,
    cholupdate_dense,
    cholupdate_dense_batched,
    cholupdate_dense_t,
    cholupdate_window,
    cholupdate_window_t,
    ridge_solve_from_factor,
    ridge_solve_from_factor_batched,
    ridge_solve_from_factor_t,
    ridge_solve_from_factor_t_batched,
    seed_factor,
)
from repro_torch.core.backprop import (  # noqa: F401
    forward,
    grads_truncated,
    grads_truncated_manual,
    grads_full_bptt,
    loss_from_logits,
)
from repro_torch.core.dfr import DFRModel  # noqa: F401
from repro_torch.core.online import (  # noqa: F401
    OnlineDFR,
    OnlineEnsemble,
    OnlineState,
    init_state,
    online_infer,
    online_logits,
    online_serve_step,
    online_step,
    refresh_output,
    refresh_output_batched,
    reset_statistics,
)
from repro_torch.core.readout import (  # noqa: F401
    DistributedDFRReadout,
    ReadoutConfig,
)
from repro_torch.core.population import (  # noqa: F401
    PopulationEval,
    PopulationResult,
    cull_population,
    evaluate_population,
    grid_candidates,
    init_population,
    refine_population,
    train_population,
    train_population_classification,
    train_population_regression,
)
from repro_torch.core.grid_search import (  # noqa: F401
    grid_search,
    grid_search_serial,
    grid_search_until,
)
