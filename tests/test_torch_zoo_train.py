"""Train-step parity of slice 4's models against the JAX package on the CPU.

``test_torch_train.check_train_step_parity`` for dcn, deepcrossing, deepfm,
fibinet, autoint, bst (at f32) and dien (with the auxiliary loss and
``gru_hidden_dim=8``, so that ``aux_proj`` trains too), at the tiny schema,
narrow widths and dropout 0: the loss and every gradient at step 1, then
every parameter and BatchNorm statistic after 3 Adam steps, at rtol 1e-4 /
atol 1e-5. The Dense biases that feed a BatchNorm in a bn_act tower
(DeepFM's ``MLPTower_0``, FiBiNet's and BST's ``dnn``) and those
BatchNorms' running means are held at that test's noise bars. So is each
BST block's key bias ``w_k.bias``: it adds q . b_k to every score of a
query row alike, which the softmax cancels, so its gradient is rounding
noise and Adam's steps of +-lr have no sign to agree on (atol = 3 * lr).
The last block's ``norm2.bias`` likewise: the mean pool passes it to every
row as the same vector, and the tower's first train-mode BatchNorm
subtracts it again with the batch mean.
"""

import pytest

from test_torch_train import bn_fed_bias_noise, check_train_step_parity

LR = 0.005
F32 = dict(transformer_dtype="float32", transformer_score_dtype="float32")
CASES = {
    "dcn": (dict(hidden_units=(32, 16), num_cross_layers=2), {}),
    "deepcrossing": (dict(residual_internal_dim=32), {}),
    "deepfm": (dict(hidden_units=(32, 16), embedding_dim=8, dropout_rate=0.0),
               bn_fed_bias_noise("MLPTower_0", 2, LR)),
    "fibinet": (dict(hidden_units=(32, 16), embedding_dim=8, dropout_rate=0.0),
                bn_fed_bias_noise("dnn", 2, LR)),
    "autoint": (dict(embedding_dim=8, autoint_layers=2, autoint_att_dim=8, **F32), {}),
    "bst": (dict(hidden_units=(32, 16), dropout_rate=0.0, **F32),
            {**bn_fed_bias_noise("dnn", 2, LR),
             **{f"transformer_{i}.w_k.bias": 3 * LR for i in range(2)},
             "transformer_1.norm2.bias": 3 * LR}),
    "dien": (dict(hidden_units=(32, 16), gru_hidden_dim=8, use_aux_loss=True,
                  dropout_rate=0.0), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_train_step_parity(name):
    overrides, noise = CASES[name]
    got, _ = check_train_step_parity(name, overrides, noise, LR)
    if name == "dien":
        assert "aux_proj.weight" in got
