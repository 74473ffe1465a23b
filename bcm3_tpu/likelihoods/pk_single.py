"""Single-patient pharmacokinetic trajectory likelihood.

JAX equivalent of the reference single-patient PK workload
(reference: src/likelihoods/LikelihoodPharmacokineticTrajectory.cpp).
It is the PopPK model restricted to one patient with the PK parameters
sampled directly (no population-level non-centered transform,
LikelihoodPharmacokineticTrajectory.cpp:255-290), so the simulation
machinery — exact matrix-exponential propagation over dosing intervals
for the linear models, batched DP5 for transit models — is inherited
from PopPKLikelihood (bcm3_tpu/likelihoods/poppk.py).

Variable layout (reference: LikelihoodPharmacokineticTrajectory.cpp
:247-290): index 0 = absorption, 1 = excretion, 2 = elimination
(divided by the volume of distribution), 3 = volume of distribution,
4/5 = periphery forward/backward (two-compartment models),
6/7 = biphasic switch time / second absorption rate,
``n_transit``/``mean_transit_time`` by name (transit models),
``standard_deviation`` by name with the proportional term at the next
index. Residuals are Student-t(nu=4) with sd + sd2*max(x,0)
(:330-333).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from bcm3_tpu.likelihoods.poppk import PopPKLikelihood, PopPKTrial
from bcm3_tpu.model.variables import VariableSet


def select_patient(trial: PopPKTrial, patient_id: str) -> PopPKTrial:
    """Restrict a trial to one patient (reference loads only the requested
    patient row, LikelihoodPharmacokineticTrajectory.cpp:163-186)."""
    ids = [
        p.decode() if isinstance(p, bytes) else str(p) for p in trial.patient_ids
    ]
    if patient_id not in ids:
        raise ValueError(f"Cannot find patient '{patient_id}' in data file")
    j = ids.index(patient_id)
    sel = slice(j, j + 1)
    return PopPKTrial(
        time=trial.time,
        patient_ids=trial.patient_ids[sel],
        observed=trial.observed[sel],
        dose=trial.dose[sel],
        dose_after_dose_change=trial.dose_after_dose_change[sel],
        dose_change_time=trial.dose_change_time[sel],
        dosing_interval=trial.dosing_interval[sel],
        intermittent=trial.intermittent[sel],
        interruptions=trial.interruptions[sel],
    )


class SinglePatientPKLikelihood(PopPKLikelihood):
    """``params -> logp`` for one patient with directly-sampled PK params."""

    def __init__(
        self,
        varset: VariableSet,
        trial: PopPKTrial,
        pk_type: str,
        drug: str,
        fixed_vod: float = np.nan,
        fixed_periphery_fwd: float = np.nan,
        fixed_periphery_bwd: float = np.nan,
    ):
        if trial.num_patients != 1:
            raise ValueError(
                "SinglePatientPKLikelihood requires a single-patient trial "
                "(use select_patient)"
            )
        self._skip_varset_check = True
        super().__init__(
            varset,
            trial,
            pk_type,
            drug,
            fixed_vod=fixed_vod,
            fixed_periphery_fwd=fixed_periphery_fwd,
            fixed_periphery_bwd=fixed_periphery_bwd,
        )

    def _patient_params(self, values):
        """Directly-sampled parameters, broadcast to the (P=1,) patient axis
        (reference: LikelihoodPharmacokineticTrajectory.cpp:255-290)."""
        one = jnp.ones((1,), dtype=values.dtype)
        ka = self._transform(0, values[0]) * one
        ke = self._transform(1, values[1])
        vod = (
            self._transform(3, values[3])
            if not np.isfinite(self.fixed_vod)
            else jnp.asarray(self.fixed_vod, dtype=values.dtype)
        )
        kel = self._transform(2, values[2]) / vod * one
        params = {"ka": ka, "ke": ke, "vod": vod, "kel": kel}
        if self.n_states == 3:
            if not np.isfinite(self.fixed_periphery_fwd):
                params["kpf"] = self._transform(4, values[4])
                params["kpb"] = self._transform(5, values[5])
            else:
                params["kpf"] = jnp.asarray(
                    self.fixed_periphery_fwd, dtype=values.dtype
                )
                params["kpb"] = jnp.asarray(
                    self.fixed_periphery_bwd, dtype=values.dtype
                )
        if self.pk_type in ("one_transit", "two_transit"):
            nt_ix = self._named_ix["n_transit"]
            mt_ix = self._named_ix["mean_transit_time"]
            n_transit = self._transform(nt_ix, values[nt_ix])
            params["n_transit"] = n_transit
            params["k_transit"] = (n_transit + 1.0) / self._transform(
                mt_ix, values[mt_ix]
            )
        if self.pk_type == "two_biphasic":
            # biphasic switch time / second absorption at fixed indices 6/7
            # (reference: LikelihoodPharmacokineticTrajectory.cpp:282-287)
            switch = self._transform(6, values[6])
            params["switch_time"] = (
                jnp.minimum(
                    switch, jnp.asarray(float(self.trial.dosing_interval[0])) - 1e-2
                )
                * one
            )
            params["ka2"] = self._transform(7, values[7])
        sd = self._transform(self.sd_ix, values[self.sd_ix])
        sd2 = self._transform(self.sd_ix + 1, values[self.sd_ix + 1])
        return params, sd, sd2


def create_pk_likelihood(varset: VariableSet, attrs):
    """Factory entry (reference: LikelihoodFactory.cpp
    'pharmacokinetic_trajectory'); patient can come from the XML or the
    ``pk.patient`` command-line option
    (LikelihoodPharmacokineticTrajectory.cpp:226-234)."""
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError(
            "pharmacokinetic_trajectory likelihood requires an XML definition"
        )
    node = root.find("pk_model")
    if node is None:
        raise ValueError("likelihood XML must contain a <pk_model> element")
    patient = attrs.get("pk.patient") or node.get("patient")
    if not patient:
        raise ValueError(
            "Patient ID has not been specified in either the likelihood or "
            "as an option"
        )
    drug = node.get("drug")
    pkdata_file = node.get("pkdata_file", "pkdata.nc")
    trial = PopPKTrial.load(pkdata_file, node.get("trial"), drug)
    return SinglePatientPKLikelihood(
        varset,
        select_patient(trial, patient),
        node.get("type"),
        drug,
        fixed_vod=float(node.get("volume_of_distribution", "nan")),
        fixed_periphery_fwd=float(node.get("k_periphery_fwd", "nan")),
        fixed_periphery_bwd=float(node.get("k_periphery_bwd", "nan")),
    )
