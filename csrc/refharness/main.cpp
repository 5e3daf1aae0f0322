// Reference-execution parity harness: drives the GAUSS reference's
// exported analyses (compiled in place from /root/reference/src via
// the Rcpp facade in Rcpp.h) on bgzf panels and emits TSV on stdout
// for tests/test_ref_harness.py to diff against gauss_jax.
// Reference entry points:
//   dist           /root/reference/src/dist.cpp:30
//   distmix        /root/reference/src/distmix.cpp:30
//   computeLD      /root/reference/src/computeLD.cpp:26
//   qcat           /root/reference/src/qcat.cpp:30
//   qcatmix        /root/reference/src/qcatmix.cpp:30
//   prep_qcat      /root/reference/src/prep_qcat.cpp:36
//   prep_recessive_impute  /root/reference/src/prep_qcatmix.cpp:36
//   afmix          /root/reference/src/afmix.cpp:30
//   cpw2           /root/reference/src/cpw2.cpp:31
//   jepeg          /root/reference/src/jepeg.cpp:28
//   jepegmix       /root/reference/src/jepegmix.cpp:26
//   prep_zmix{,2,3,4,5,5_sup}  /root/reference/src/zmix.cpp
//
// Usage:
//   refharness CMD chr start end wing POP z idx dat popdesc [x1] [x2]
// where POP is a study pop name (dist/qcat/jepeg/prep_qcat) or a
// "P1=w,P2=w" weight spec (*mix), and x1/x2 are per-command extras
// ("-" or absent = R NULL):
//   dist|distmix|computeld|qcat|qcatmix|prep_qcat|
//     prep_recessive_impute            x1 = af1_cutoff (double)
//   afmix|cpw2                         x1 = interval (int); z = AF file
//   jepeg|jepegmix                     x1 = af1_cutoff, x2 = annot file
//   prep_zmix                          x1 = interval
//   prep_zmix2|prep_zmix4              x1 = interval, x2 = offset
//   prep_zmix3                         x1 = interval, x2 = steps
//   prep_zmix5|prep_zmix5_sup          x1 = percentile, x2 = interval
#include <cstdio>
#include <cstdlib>
#include <sstream>
#include <string>

#include "Rcpp.h"

using namespace Rcpp;

// the [[Rcpp::export]] functions, as defined in the reference sources
DataFrame dist(int chr, long long int start_bp, long long int end_bp,
               long long int wing_size, std::string study_pop,
               std::string input_file, std::string reference_index_file,
               std::string reference_data_file,
               std::string reference_pop_desc_file,
               Rcpp::Nullable<double> af1_cutoff);
DataFrame distmix(int chr, long long int start_bp, long long int end_bp,
                  long long int wing_size, DataFrame pop_wgt_df,
                  std::string input_file,
                  std::string reference_index_file,
                  std::string reference_data_file,
                  std::string reference_pop_desc_file,
                  Rcpp::Nullable<double> af1_cutoff);
List computeLD(int chr, long long int start_bp, long long int end_bp,
               DataFrame pop_wgt_df, std::string input_file,
               std::string reference_index_file,
               std::string reference_data_file,
               std::string reference_pop_desc_file,
               Rcpp::Nullable<double> af1_cutoff);
DataFrame qcat(int chr, long long int start_bp, long long int end_bp,
               long long int wing_size, std::string study_pop,
               std::string input_file, std::string reference_index_file,
               std::string reference_data_file,
               std::string reference_pop_desc_file,
               Rcpp::Nullable<double> af1_cutoff);
DataFrame qcatmix(int chr, long long int start_bp, long long int end_bp,
                  long long int wing_size, DataFrame pop_wgt_df,
                  std::string input_file,
                  std::string reference_index_file,
                  std::string reference_data_file,
                  std::string reference_pop_desc_file,
                  Rcpp::Nullable<double> af1_cutoff);
List prep_qcat(int chr, long long int start_bp, long long int end_bp,
               long long int wing_size, std::string study_pop,
               std::string input_file, std::string reference_index_file,
               std::string reference_data_file,
               std::string reference_pop_desc_file,
               Rcpp::Nullable<double> af1_cutoff);
List prep_recessive_impute(int chr, long long int start_bp,
                           long long int end_bp, long long int wing_size,
                           DataFrame pop_wgt_df, std::string input_file,
                           std::string reference_index_file,
                           std::string reference_data_file,
                           std::string reference_pop_desc_file,
                           Rcpp::Nullable<double> af1_cutoff);
DataFrame afmix(std::string input_file, std::string reference_index_file,
                std::string reference_data_file,
                std::string reference_pop_desc_file,
                Rcpp::Nullable<int> interval);
DataFrame cpw2(std::string input_file, std::string reference_index_file,
               std::string reference_data_file,
               std::string reference_pop_desc_file,
               Rcpp::Nullable<int> interval);
DataFrame jepeg(std::string study_pop, std::string input_file,
                std::string annotation_file,
                std::string reference_index_file,
                std::string reference_data_file,
                std::string reference_pop_desc_file,
                Rcpp::Nullable<double> af1_cutoff);
DataFrame jepegmix(DataFrame pop_wgt_df, std::string input_file,
                   std::string annotation_file,
                   std::string reference_index_file,
                   std::string reference_data_file,
                   std::string reference_pop_desc_file,
                   Rcpp::Nullable<double> af1_cutoff);
NumericMatrix prep_zmix(std::string input_file,
                        std::string reference_index_file,
                        std::string reference_data_file,
                        std::string reference_pop_desc_file,
                        Rcpp::Nullable<int> interval);
NumericMatrix prep_zmix2(std::string input_file,
                         std::string reference_index_file,
                         std::string reference_data_file,
                         std::string reference_pop_desc_file,
                         Rcpp::Nullable<int> interval,
                         Rcpp::Nullable<int> offset);
NumericMatrix prep_zmix3(std::string input_file,
                         std::string reference_index_file,
                         std::string reference_data_file,
                         std::string reference_pop_desc_file,
                         Rcpp::Nullable<int> interval,
                         Rcpp::Nullable<int> steps);
NumericMatrix prep_zmix4(std::string input_file,
                         std::string reference_index_file,
                         std::string reference_data_file,
                         std::string reference_pop_desc_file,
                         Rcpp::Nullable<int> interval,
                         Rcpp::Nullable<int> offset);
// declared NumericVector in the reference (zmix.cpp:44) but returns a
// NumericMatrix; the facade's converting ctor keeps the dims
NumericVector prep_zmix5(std::string input_file,
                         std::string reference_index_file,
                         std::string reference_data_file,
                         std::string reference_pop_desc_file,
                         Rcpp::Nullable<double> percentile,
                         Rcpp::Nullable<int> interval);
NumericMatrix prep_zmix5_sup(std::string input_file,
                             std::string reference_index_file,
                             std::string reference_data_file,
                             std::string reference_pop_desc_file,
                             Rcpp::Nullable<double> percentile,
                             Rcpp::Nullable<int> interval);

static DataFrame parse_pop_wgt(const std::string &s) {
  StringVector pops;
  NumericVector wgts;
  std::stringstream ss(s);
  std::string tok;
  while (std::getline(ss, tok, ',')) {
    auto eq = tok.find('=');
    if (eq == std::string::npos) throw std::runtime_error("bad pop=w: " + tok);
    pops.push_back(tok.substr(0, eq));
    wgts.push_back(std::stod(tok.substr(eq + 1)));
  }
  return DataFrame::create(Named("pop") = pops, Named("wgt") = wgts);
}

static void print_df(const DataFrame &df) {
  for (size_t c = 0; c < df.names.size(); c++)
    printf("%s%s", c ? "\t" : "", df.names[c].c_str());
  printf("\n");
  size_t n = df.nrows();
  for (size_t r = 0; r < n; r++) {
    for (size_t c = 0; c < df.cols.size(); c++) {
      if (c) printf("\t");
      const Column &col = df.cols[c];
      if (std::holds_alternative<StringVector>(col))
        printf("%s", std::get<StringVector>(col)[r].c_str());
      else if (std::holds_alternative<IntegerVector>(col))
        printf("%d", std::get<IntegerVector>(col)[r]);
      else
        printf("%.10g", std::get<NumericVector>(col)[r]);
    }
    printf("\n");
  }
}

static void print_mat(const NumericMatrix &m) {
  for (size_t i = 0; i < m.nrow(); i++) {
    for (size_t j = 0; j < m.ncol(); j++)
      printf("%s%.10g", j ? "\t" : "", m(i, j));
    printf("\n");
  }
}

static void print_vec(const NumericVector &v) {
  for (size_t i = 0; i < v.size(); i++)
    printf("%s%.10g", i ? "\t" : "", v[i]);
  printf("\n");
}

// List sections: "##<name>" separator, then df/matrix/vector payload
static void print_list(const List &l) {
  for (size_t i = 0; i < l.names.size(); i++) {
    if (i) printf("##%s\n", l.names[i].c_str());
    const ListItem &it = l.items[i];
    if (std::holds_alternative<DataFrame>(it))
      print_df(std::get<DataFrame>(it));
    else if (std::holds_alternative<NumericMatrix>(it))
      print_mat(std::get<NumericMatrix>(it));
    else
      print_vec(std::get<NumericVector>(it));
  }
}

int main(int argc, char **argv) {
  if (argc < 11) {
    fprintf(stderr,
            "usage: %s CMD chr start end wing pop_spec z_file idx_file "
            "dat_file popdesc_file [x1] [x2]\n",
            argv[0]);
    return 2;
  }
  std::string cmd = argv[1];
  int chr = atoi(argv[2]);
  long long start_bp = atoll(argv[3]);
  long long end_bp = atoll(argv[4]);
  long long wing = atoll(argv[5]);
  std::string pop_spec = argv[6];
  std::string zf = argv[7], idxf = argv[8], datf = argv[9], popf = argv[10];
  std::string x1 = (argc > 11) ? argv[11] : "-";
  std::string x2 = (argc > 12) ? argv[12] : "-";
  Nullable<double> x1d = R_NilValue;
  Nullable<int> x1i = R_NilValue;
  if (x1 != "-") {
    x1d = Nullable<double>(atof(x1.c_str()));
    x1i = Nullable<int>(atoi(x1.c_str()));
  }
  Nullable<double> x2d = R_NilValue;
  Nullable<int> x2i = R_NilValue;
  if (x2 != "-") {
    x2d = Nullable<double>(atof(x2.c_str()));
    x2i = Nullable<int>(atoi(x2.c_str()));
  }

  try {
    if (cmd == "dist") {
      print_df(dist(chr, start_bp, end_bp, wing, pop_spec, zf, idxf, datf,
                    popf, x1d));
    } else if (cmd == "distmix") {
      print_df(distmix(chr, start_bp, end_bp, wing, parse_pop_wgt(pop_spec),
                       zf, idxf, datf, popf, x1d));
    } else if (cmd == "computeld") {
      List l = computeLD(chr, start_bp, end_bp, parse_pop_wgt(pop_spec), zf,
                         idxf, datf, popf, x1d);
      print_df(std::get<DataFrame>(l["snplist"]));
      printf("##cormat\n");
      print_mat(std::get<NumericMatrix>(l["cormat"]));
    } else if (cmd == "qcat") {
      print_df(qcat(chr, start_bp, end_bp, wing, pop_spec, zf, idxf, datf,
                    popf, x1d));
    } else if (cmd == "qcatmix") {
      print_df(qcatmix(chr, start_bp, end_bp, wing, parse_pop_wgt(pop_spec),
                       zf, idxf, datf, popf, x1d));
    } else if (cmd == "prep_qcat") {
      print_list(prep_qcat(chr, start_bp, end_bp, wing, pop_spec, zf, idxf,
                           datf, popf, x1d));
    } else if (cmd == "prep_recessive_impute") {
      print_list(prep_recessive_impute(chr, start_bp, end_bp, wing,
                                       parse_pop_wgt(pop_spec), zf, idxf,
                                       datf, popf, x1d));
    } else if (cmd == "afmix") {
      print_df(afmix(zf, idxf, datf, popf, x1i));
    } else if (cmd == "cpw2") {
      print_df(cpw2(zf, idxf, datf, popf, x1i));
    } else if (cmd == "jepeg") {
      print_df(jepeg(pop_spec, zf, x2, idxf, datf, popf, x1d));
    } else if (cmd == "jepegmix") {
      print_df(jepegmix(parse_pop_wgt(pop_spec), zf, x2, idxf, datf, popf,
                        x1d));
    } else if (cmd == "prep_zmix") {
      print_mat(prep_zmix(zf, idxf, datf, popf, x1i));
    } else if (cmd == "prep_zmix2") {
      print_mat(prep_zmix2(zf, idxf, datf, popf, x1i, x2i));
    } else if (cmd == "prep_zmix3") {
      print_mat(prep_zmix3(zf, idxf, datf, popf, x1i, x2i));
    } else if (cmd == "prep_zmix4") {
      print_mat(prep_zmix4(zf, idxf, datf, popf, x1i, x2i));
    } else if (cmd == "prep_zmix5") {
      NumericVector v = prep_zmix5(zf, idxf, datf, popf, x1d, x2i);
      NumericMatrix m(v.attr_nrow, v.attr_ncol);
      m.v = v.v;  // row-major flatten from the facade's converting ctor
      print_mat(m);
    } else if (cmd == "prep_zmix5_sup") {
      print_mat(prep_zmix5_sup(zf, idxf, datf, popf, x1d, x2i));
    } else {
      fprintf(stderr, "unknown command %s\n", cmd.c_str());
      return 2;
    }
  } catch (const std::exception &e) {
    fprintf(stderr, "refharness error: %s\n", e.what());
    return 1;
  }
  return 0;
}
