"""The PCA model container and its pickles, on the host — the half of the
port of ``dynamorph_tpu/reduce/pca.py`` that needs neither torch nor
sklearn.

``pca_model.pkl`` unpickles as a real ``sklearn.decomposition.PCA``
wherever sklearn is installed (the reference pipeline loads it directly),
but the port writes it without sklearn: the pickle stream is built by hand
(``dumps_sklearn_pca``). ``process_pca`` (reference
run_dim_reduction.py:53-92) reads a real sklearn PCA, the port's pickle
and the JAX package's ``PCAModel`` without sklearn and without the JAX
package (``load_pca_model``), and transforms on the host.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..io.compact import load_array_any
from ..io.pickles import save_pickle

# the sklearn release whose PCA attributes dumps_sklearn_pca writes (the
# ones sklearn 1.9's PCA pickles hold); sklearn warns when another release
# loads the file, as it does for any pickle of its estimators
SKLEARN_STATE_VERSION = "1.9.0"

# the classes a pca_model.pkl may name: sklearn's PCA (now and before
# sklearn 0.22), the JAX package's fallback container and this module's
_PCA_CLASSES = {("sklearn.decomposition._pca", "PCA"),
                ("sklearn.decomposition.pca", "PCA"),
                ("dynamorph_tpu.reduce.pca", "PCAModel"),
                ("dynamorph_tpu_torch.reduce.pca_model", "PCAModel")}


class PCAModel:
    """Minimal sklearn-compatible PCA container. It is also what
    ``load_pca_model`` builds from a sklearn or JAX-package pickle, whose
    attributes it takes as they are."""

    whiten = False

    def __init__(self, components: np.ndarray, mean: np.ndarray,
                 explained_variance: np.ndarray,
                 explained_variance_ratio: np.ndarray):
        self.components_ = components
        self.mean_ = mean
        self.explained_variance_ = explained_variance
        self.explained_variance_ratio_ = explained_variance_ratio
        self.n_components_ = components.shape[0]

    def transform(self, X: np.ndarray) -> np.ndarray:
        """sklearn's rule: centre, project, and with ``whiten`` divide by
        the square root of the explained variance."""
        out = (np.asarray(X) - self.mean_) @ self.components_.T
        if self.whiten:
            out /= np.sqrt(self.explained_variance_)
        return out


class _PCAUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _PCA_CLASSES:
            return PCAModel
        return super().find_class(module, name)


def load_pca_model(path: str) -> PCAModel:
    """A ``pca_model.pkl`` of any of the three kinds, as a ``PCAModel``:
    neither sklearn nor the JAX package is imported."""
    with open(path, "rb") as f:
        return _PCAUnpickler(f).load()


def _sklearn_state(pca: PCAModel, n_samples: int) -> dict:
    """The attribute dict of the sklearn PCA that the JAX package's
    ``_as_sklearn_pca`` builds, in its order."""
    ev = np.asarray(pca.explained_variance_, np.float64)
    components = np.asarray(pca.components_, np.float64)
    return {
        "n_components": int(pca.n_components_),
        "copy": True,
        "whiten": False,
        "svd_solver": "auto",
        "tol": 0.0,
        "iterated_power": "auto",
        "n_oversamples": 10,
        "power_iteration_normalizer": "auto",
        "random_state": None,
        "components_": components,
        "mean_": np.asarray(pca.mean_, np.float64),
        "explained_variance_": ev,
        "explained_variance_ratio_": np.asarray(
            pca.explained_variance_ratio_, np.float64),
        "singular_values_": np.sqrt(np.maximum(ev, 0.0)
                                    * max(n_samples - 1, 1)),
        "n_components_": int(pca.n_components_),
        "n_features_in_": int(components.shape[1]),
        "n_samples_": int(n_samples),
        "noise_variance_": 0.0,
        "_sklearn_version": SKLEARN_STATE_VERSION,
    }


def _short_unicode(s: str) -> bytes:
    data = s.encode()
    return b"\x8c" + bytes([len(data)]) + data        # SHORT_BINUNICODE


def dumps_sklearn_pca(pca: PCAModel, n_samples: int) -> bytes:
    """The protocol-4 pickle of a ``sklearn.decomposition.PCA`` holding the
    fit, written without sklearn: PROTO 4; STACK_GLOBAL
    ``sklearn.decomposition._pca PCA``; EMPTY_TUPLE; NEWOBJ (no MEMOIZE, so
    the state's own memo indices stand); the state dict as
    ``pickle.dumps`` writes it, without its STOP; BUILD; STOP."""
    head = (b"\x80\x04" + _short_unicode("sklearn.decomposition._pca")
            + _short_unicode("PCA") + b"\x93" + b")" + b"\x81")
    state = pickle.dumps(_sklearn_state(pca, n_samples), protocol=4)
    if not state.endswith(b"."):
        raise ValueError("unexpected pickle stream: no STOP at its end")
    return head + state[:-1] + b"b."


def process_pca(input_dir: str, output_dir: str, weights_dir: str,
                prefix: str, suffix: str = "_after") -> None:
    """Transform latent pickles with a saved PCA model
    (reference run_dim_reduction.py:53-92), on the host. Reads
    ``{prefix}_latent_space{suffix}.pkl`` (or its .npz), writes
    ``{prefix}_latent_space{suffix}_PCAed.pkl``."""
    os.makedirs(output_dir, exist_ok=True)
    model_path = os.path.join(weights_dir, "pca_model.pkl")
    try:
        pca = load_pca_model(model_path)
    except Exception as ex:
        raise ValueError(
            f"Error in loading pre-saved PCA weights: {ex}") from ex

    input_fname = f"{prefix}_latent_space{suffix}.pkl"
    output_fname = f"{prefix}_latent_space{suffix}_PCAed.pkl"
    dats = load_array_any(os.path.join(input_dir, input_fname))
    save_pickle(pca.transform(dats), os.path.join(output_dir, output_fname))
