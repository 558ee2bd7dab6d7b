// Constants of the stiff tier as the kernels read them: the values of
// ivp_tpu_torch/tableaus.py (Radau IIA(5): the nodes, T and TI, the error
// weights DD, the eigenvalues U1 and ALPH +- i BETA; BDF: gamma, alpha, the
// error constants and kappa) and of methods/bdf.py::CHANGE_D_C, each printed
// to round-trip in double (tests/test_torch_tableaus.py holds them equal).
// The tables a lane indexes by its order sit in the constant bank;
// CHANGE_D_C is read at compile time (bdf.cu's change_d).
#pragma once

namespace ivp {
namespace radau {
constexpr double C1 = 0.15505102572168222;
constexpr double C2 = 0.6449489742783178;
constexpr double C1M1 = -0.8449489742783178;
constexpr double C2M1 = -0.35505102572168223;
constexpr double C1MC2 = -0.48989794855663554;
constexpr double U1 = 3.637834252744496;
constexpr double ALPH = 2.6810828736277523;
constexpr double BETA = 3.0504301992474105;
constexpr double DD_0 = -10.048809399827414;
constexpr double DD_1 = 1.382142733160748;
constexpr double DD_2 = -0.3333333333333333;
constexpr double T_0_0 = 0.09123239487089295;
constexpr double T_0_1 = -0.1412552950209542;
constexpr double T_0_2 = -0.030029194105147424;
constexpr double T_1_0 = 0.241717932707107;
constexpr double T_1_1 = 0.20412935229379994;
constexpr double T_1_2 = 0.3829421127572619;
constexpr double T_2_0 = 0.966048182615093;
constexpr double T_2_1 = 1.0;
constexpr double T_2_2 = 0.0;
constexpr double TI_0_0 = 4.325579890063155;
constexpr double TI_0_1 = 0.33919925181580984;
constexpr double TI_0_2 = 0.5417705399358749;
constexpr double TI_1_0 = -4.178718591551905;
constexpr double TI_1_1 = -0.32768282076106237;
constexpr double TI_1_2 = 0.47662355450055044;
constexpr double TI_2_0 = -0.5028726349457868;
constexpr double TI_2_1 = 2.571926949855605;
constexpr double TI_2_2 = -0.5960392048282249;
}  // namespace radau
namespace bdf {
constexpr int MAX_ORDER = 5;
__constant__ double KAPPA[6] = {0.0, -0.185, -0.1111111111111111, -0.0823, -0.0415, 0.0};
__constant__ double GAMMA[6] = {0.0, 1.0, 1.5, 1.8333333333333333, 2.083333333333333, 2.283333333333333};
__constant__ double ALPHA[6] = {0.0, 1.185, 1.6666666666666667, 1.9842166666666667, 2.1697916666666663, 2.283333333333333};
__constant__ double ERROR_CONST[6] = {1.0, 0.315, 0.16666666666666666, 0.09911666666666669, 0.11354166666666668, 0.16666666666666666};
// CHANGE_D_C[d][i][m]: the coefficient of factor^d in (R(factor) R(1))[i][m].
constexpr double CHANGE_D_C[6][6][6] = {
  {
    {1.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
  },
  {
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 1.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.5, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.3333333333333333, 0.0, 0.0, -2.220446049250313e-16, 4.440892098500626e-16},
    {0.0, 0.25, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.2, 0.0, 0.0, 0.0, 8.881784197001252e-16},
  },
  {
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, -0.5, 1.0, 0.0, 0.0, 0.0},
    {0.0, -0.5, 1.0, 0.0, 0.0, 0.0},
    {0.0, -0.4583333333333333, 0.9166666666666666, 0.0, -8.881784197001252e-16, -3.552713678800501e-15},
    {0.0, -0.4166666666666667, 0.8333333333333334, 0.0, 8.881784197001252e-16, 5.329070518200751e-15},
  },
  {
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.16666666666666666, -1.0, 1.0, 1.7763568394002505e-15, 7.105427357601002e-15},
    {0.0, 0.25, -1.5, 1.5, 0.0, 0.0},
    {0.0, 0.2916666666666667, -1.75, 1.75, -3.552713678800501e-15, -1.4210854715202004e-14},
  },
  {
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, -0.041666666666666664, 0.5833333333333333, -1.5, 1.0, -1.0658141036401503e-14},
    {0.0, -0.08333333333333334, 1.1666666666666667, -3.0, 2.0000000000000036, 1.4210854715202004e-14},
  },
  {
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 0.008333333333333333, -0.25, 1.25, -2.0, 1.000000000000007},
  },
};
}  // namespace bdf
}  // namespace ivp
